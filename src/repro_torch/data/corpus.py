"""Synthetic LM corpus mapped into the object store.

The corpus is a LogicalDataset of whole training sequences:
  columns: tokens  int32 (seq_len,)   — planar-bitpacked at rest
           doc_id  int32              — provenance tag (filter demos)
           quality float32            — score column (filter/agg demos)

Token stream: a two-level Zipf-Markov sampler — cheap, deterministic, and
non-uniform enough that compression and loss curves behave like text.
Everything is written through GlobalVOL so partitioning, placement,
replication, and codecs all come from the paper's machinery.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.logical import Column, LogicalDataset, RowRange
from repro_torch.core.partition import ObjectMap, PartitionPolicy
from repro_torch.core.vol import GlobalVOL


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    name: str = "corpus"
    n_seqs: int = 1024
    seq_len: int = 256
    vocab_size: int = 50_000
    seed: int = 0

    def dataset(self) -> LogicalDataset:
        if self.seq_len % 32:
            raise ValueError("seq_len must be a multiple of 32 "
                             "(planar bitpack group size)")
        return LogicalDataset(
            self.name,
            (Column("tokens", "int32", (self.seq_len,)),
             Column("doc_id", "int32"),
             Column("quality", "float32")),
            n_rows=self.n_seqs,
            unit_rows=max(1, min(64, self.n_seqs)),
        )


def synth_tokens(rng: np.random.Generator, n_seqs: int, seq_len: int,
                 vocab: int) -> np.ndarray:
    """Zipf unigrams + short Markov motifs (repeat-prev with p=0.3)."""
    # Zipf ranks -> token ids; clip to vocab
    z = rng.zipf(1.3, size=(n_seqs, seq_len)).astype(np.int64)
    toks = (z % vocab).astype(np.int32)
    rep = rng.random((n_seqs, seq_len)) < 0.3
    rep[:, 0] = False
    out = toks.copy()
    for j in range(1, seq_len):
        out[:, j] = np.where(rep[:, j], out[:, j - 1], toks[:, j])
    return out


def build_corpus(vol: GlobalVOL, spec: CorpusSpec,
                 policy: PartitionPolicy | None = None,
                 *, chunk_rows: int = 512) -> ObjectMap:
    """Generate and ingest the corpus through the VOL (chunked so memory
    stays bounded for big corpora)."""
    ds = spec.dataset()
    policy = policy or PartitionPolicy(
        target_object_bytes=4 << 20, max_object_bytes=32 << 20)
    omap = vol.create(ds, policy)
    rng = np.random.default_rng(spec.seed)
    for start in range(0, spec.n_seqs, chunk_rows):
        stop = min(start + chunk_rows, spec.n_seqs)
        n = stop - start
        table = {
            "tokens": synth_tokens(rng, n, spec.seq_len, spec.vocab_size),
            "doc_id": rng.integers(0, max(spec.n_seqs // 16, 1),
                                   n).astype(np.int32),
            "quality": rng.beta(4, 2, n).astype(np.float32),
        }
        vol.write(omap, table, rows=RowRange(start, stop))
    return omap
