"""The comparisons that decide a run's ``correct``, and what they read.

Training (a step's loss, each leaf's gradient norm, each leaf's change)
is compared by the gap between the program's number and the
reference's, relative to the reference's.  A leaf's norm is compared
against the reference's norm of that leaf or of the median leaf,
whichever is larger, since some gradients are all but zero; a leaf whose
reference gradient is under a thousandth of the median leaf's is left
out of the change, which round-off alone moves under Adam.

Serving is compared by how far below the reference's best logit each
served token's reference logit lies: zero where the program served the
token the reference ranks first.

The consumed rows of a training step are read back from the packed
words the step was fed (the planar bitpack layout: word i of a 32-value
group holds bit i of each of the 32 values) and looked up among the
benchmark's own corpus rows.
"""

from __future__ import annotations

import statistics
import zlib

import numpy as np
import torch


def rel_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


def leaf_gap(prog: dict[str, float], ref: dict[str, float],
             names=None) -> tuple[float, str]:
    """(the worst leaf's |prog - ref| / max(ref, median ref), its name)
    over ``names`` (default: every leaf of ``ref``)."""
    names = list(ref if names is None else names)
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        g = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if g > worst:
            worst, at = g, n
    return worst, at


def sample_index(name: str, numel: int, k: int = 4096) -> torch.Tensor:
    """``k`` flat indices of a leaf (all of a smaller one), drawn from
    its name: the entries both sides' gradients and changes are read
    at."""
    if numel <= k:
        return torch.arange(numel)
    gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
    return torch.randint(numel, (k,), generator=gen)


def probes(layout) -> dict[str, torch.Tensor]:
    """``sample_index`` of every leaf of a ``lm.param_layout``."""
    return {leaf.name: sample_index(leaf.name, torch.Size(leaf.shape).numel())
            for leaf in layout}


def diff_gap(prog: dict, ref: dict, names=None) -> tuple[float, str]:
    """(the worst leaf's ||prog - ref|| / max(||ref||, the median leaf's
    ||ref||) over the sampled entries, its name): unlike a gap of norms,
    first-order in an error spread over the entries."""
    names = list(ref if names is None else names)
    norms = {n: float(ref[n].float().norm()) for n in names}
    med = statistics.median(norms.values())
    worst, at = 0.0, ""
    for n in names:
        g = float((prog[n].float() - ref[n].float()).norm()) / max(
            norms[n], med, 1e-30)
        if g > worst:
            worst, at = g, n
    return worst, at


def moving_leaves(ref_grad: dict[str, float], frac: float = 1e-3
                  ) -> list[str]:
    """The leaves whose reference gradient is at least ``frac`` of the
    median leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= frac * med]


def served_gap(ref_logits: np.ndarray, served: np.ndarray) -> float:
    """max over positions of (the reference's best logit - its logit of
    the served token).  ref_logits: (n, V); served: (n,)."""
    best = ref_logits.max(axis=1)
    got = ref_logits[np.arange(len(served)), served]
    return float((best - got).max()) if len(served) else 0.0


def logit_error(got, ref) -> float:
    """max over positions of ||got - ref|| / ||ref|| of (n, V) logits."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).norm(dim=-1)
                  / ref.norm(dim=-1).clamp_min(1e-30)).max())


def bitpack_decode(words: np.ndarray, bits: int) -> np.ndarray:
    """(..., G, bits) uint32 planar words -> (..., G * 32) values."""
    w = np.asarray(words).view(np.uint32).astype(np.uint64)
    j = np.arange(32, dtype=np.uint64)
    vals = np.zeros((*w.shape[:-1], 32), np.uint64)
    for i in range(bits):
        vals |= ((w[..., i, None] >> j) & np.uint64(1)) << np.uint64(i)
    return vals.reshape(*w.shape[:-2], -1)


def match_rows(decoded: np.ndarray, corpus: np.ndarray) -> tuple[int, list]:
    """(rows of ``decoded`` that are not a corpus row, or repeat one
    already matched; the corpus index of each row, -1 where none)."""
    index = {corpus[i].tobytes(): i for i in range(len(corpus))}
    seen, bad, idx = set(), 0, []
    for row in decoded.astype(corpus.dtype):
        i = index.get(row.tobytes(), -1)
        if i < 0 or i in seen:
            bad += 1
        seen.add(i)
        idx.append(i)
    return bad, idx
