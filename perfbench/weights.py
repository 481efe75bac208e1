"""The weights of a run, drawn from its seed on the run's device.

Every leaf of ``reference.lm.param_layout`` is filled from one flat
buffer per stored dtype, each drawn by ``normal_`` from one
``torch.Generator`` seeded with the run's seed, in chunks of 2^28
values: a handful of large calls, in the dtype the leaf is stored in.
A drawn leaf is then scaled by ``fan_in ** -0.5``; a constant leaf
(norm scales 1, biases 0) is filled.  The same seed, layout and device
give the same bits, so the reference draws its own copy after the
program's state is freed rather than keeping one.
"""

from __future__ import annotations

import torch

from perfbench.reference.lm import Leaf

CHUNK = 1 << 28


def draw(layout: list[Leaf], seed: int, device) -> dict[str, torch.Tensor]:
    """``name -> tensor`` for every leaf of ``layout``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = [leaf for leaf in layout if leaf.fan_in]
    out: dict[str, torch.Tensor] = {}
    for dtype in sorted({leaf.dtype for leaf in drawn}, key=str):
        leaves = [leaf for leaf in drawn if leaf.dtype == dtype]
        sizes = [torch.Size(leaf.shape).numel() for leaf in leaves]
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
        for part in flat.split(CHUNK):
            part.normal_(generator=gen)
        for leaf, t in zip(leaves, flat.split(sizes)):
            out[leaf.name] = t.view(leaf.shape).mul_(leaf.fan_in ** -0.5)
    for leaf in layout:
        if not leaf.fan_in:
            out[leaf.name] = torch.full(leaf.shape, leaf.const,
                                        dtype=leaf.dtype, device=device)
    return {leaf.name: out[leaf.name] for leaf in layout}


@torch.no_grad()
def load_into(model: torch.nn.Module, layout: list[Leaf], seed: int) -> None:
    """Draw the weights on the model's device and copy each into the
    parameter of its name; the model must have exactly the layout's
    parameters, of its shapes and dtypes."""
    params = dict(model.named_parameters())
    want = {leaf.name: (tuple(leaf.shape), leaf.dtype) for leaf in layout}
    have = {n: (tuple(p.shape), p.dtype) for n, p in params.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise ValueError(f"the program's parameters differ from the "
                         f"configuration's layout: {diff}")
    device = next(iter(params.values())).device
    for name, t in draw(layout, seed, device).items():
        params[name].copy_(t)
