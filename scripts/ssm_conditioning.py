"""How far the recurrent models' float32 numbers move under changes of
evaluation order alone, in each package.

1. Gradients, at smoke size.  For rwkv6_3b and zamba2_2p7b with the
   reference's params (``PRNGKey(1)``) and a 4 x 32-token batch from
   ``make_batch`` seed 20 (the first batch of ``tests/test_torch_ssm.py``'s
   train-step test): the largest deviation of a leaf's gradient, as a
   fraction of that leaf's largest entry, of the reference jitted
   against the reference run eagerly (the same math in another op
   order), and of the port against the jitted reference; for zamba, the
   smallest mean square that each Mamba2 layer's gated RMS norm sees
   (its eps is 1e-5).
2. The prefill/decode invariant, at zamba2_2p7b's depth and chunk.  The
   full config (54 Mamba2 layers in 9 groups, chunk 256, state 64, SSD
   heads of 64, vocabulary 32,000) at a narrow width (d_model 320, 4
   attention heads of 80, d_ff 1024) so that it runs on a CPU, float32,
   seeded weights: how a relative perturbation of 1e-7 on the
   embeddings grows through the first group's Mamba2 layers (the port),
   then prefill of 512 tokens and 512 decode steps against prefill of
   all 1024, batch 2, in both packages on the reference's params, and
   the two packages' full prefills against each other.

Run on the CPU from the root of a checkout (JAX and the port both; ~3
minutes):
  PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/ssm_conditioning.py
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as ref_base
from repro.models import inputs as ref_inputs
from repro.models.archs import build_model as ref_build
from repro_torch.configs import get_config
from repro_torch.models import inputs as pt_inputs
from repro_torch.models import ssm as pt_ssm
from repro_torch.models import transformer as pt_tr
from repro_torch.models.archs import build_model
from repro_torch.models.layers import apply_norm, embed_tokens
from repro_torch.serve.engine import ServeEngine

NARROW = dict(d_model=320, n_heads=4, n_kv_heads=4, head_dim=80, d_ff=1024)


def _flat(tree) -> dict[str, np.ndarray]:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _worst(got: dict, want: dict) -> tuple[float, str]:
    return max((float(np.abs(got[k] - want[k]).max()
                      / np.abs(want[k]).max()), k) for k in want)


def gradients() -> None:
    for arch in ("rwkv6_3b", "zamba2_2p7b"):
        rcfg = ref_base.get_config(arch, smoke=True)
        rmodel = ref_build(rcfg, remat="none")
        params = jax.jit(rmodel.init)(jax.random.PRNGKey(1))
        rb = ref_inputs.make_batch(rcfg, 4, 32, seed=20)
        f = jax.value_and_grad(rmodel.loss, has_aux=True)
        jitted = _flat(jax.jit(f)(params, rb)[1])
        with jax.disable_jit():
            eager = _flat(f(params, rb)[1])

        cfg = get_config(arch, smoke=True)
        model = build_model(cfg, remat="none", device="cpu")
        pt_tr.params_from_reference(model, jax.device_get(params))
        seen = []
        gated = pt_ssm._mamba_gated_out

        def spy(p, y, z, x_dtype):
            seen.append(float(y.detach().float().square().mean(-1).min()))
            return gated(p, y, z, x_dtype)

        pt_ssm._mamba_gated_out = spy
        try:
            loss, _ = model.loss(pt_inputs.make_batch(cfg, 4, 32, seed=20,
                                                      device="cpu"))
        finally:
            pt_ssm._mamba_gated_out = gated
        names, ps = zip(*model.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(loss, ps)))
        port = _flat(pt_tr._map(pt_tr._reference_tree(grads),
                                lambda t: t.numpy()))
        print(f"{arch} gradients: reference eager vs jitted %.3e (%s); "
              f"port vs jitted reference %.3e (%s)"
              % (*_worst(eager, jitted), *_worst(port, jitted)))
        if seen:
            print(f"{arch}: smallest gated-norm mean square per Mamba2 layer "
                  + ", ".join(f"{m:.3e}" for m in seen) + " (eps 1e-5)")


def invariant(n_prefill: int = 512, n_decode: int = 512) -> None:
    arch = "zamba2_2p7b"
    cfg = dataclasses.replace(get_config(arch), **NARROW,
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    rcfg = dataclasses.replace(ref_base.get_config(arch), **NARROW,
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    rmodel = ref_build(rcfg, remat="none")
    params = jax.jit(rmodel.init)(jax.random.PRNGKey(0))
    model = build_model(cfg, remat="none", device="cpu")
    pt_tr.params_from_reference(model, jax.device_get(params))
    S = n_prefill + n_decode
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)

    with torch.inference_mode():
        h = embed_tokens(model.embed, torch.from_numpy(toks[:, :512]),
                         torch.float32)
        gen = torch.Generator().manual_seed(0)
        hs = [h, h * (1 + 1e-7 * torch.randn(h.shape, generator=gen))]
        growth = []
        for lyr in model.mamba[0]:
            outs = [pt_ssm.mamba2_forward(cfg, lyr.mamba, apply_norm(
                cfg, lyr.ln, x))[0] for x in hs]
            hs = [x + o for x, o in zip(hs, outs)]
            growth.append(float((hs[0] - hs[1]).abs().max()
                                / hs[0].abs().max()))
    print(f"{arch} at d_model 320, float32: a 1e-7 relative perturbation "
          "of the embeddings after each Mamba2 layer of the first group: "
          + ", ".join(f"{g:.2e}" for g in growth))

    rfull, _ = jax.jit(rmodel.prefill)(params, {"tokens": toks})
    rlogits, rcache = jax.jit(rmodel.prefill)(
        params, {"tokens": toks[:, :n_prefill]})
    rcache = dict(rcache, **{k: jnp.pad(rcache[k], [(0, 0), (0, 0),
                                                    (0, n_decode), (0, 0),
                                                    (0, 0)])
                             for k in ("k", "v")})
    decode = jax.jit(rmodel.decode_step)
    for i in range(n_prefill, S):
        rlogits, rcache = decode(params, toks[:, i:i + 1], rcache)
    with torch.inference_mode():
        full, _ = model.prefill({"tokens": torch.from_numpy(toks)})
        logits, cache = model.prefill(
            {"tokens": torch.from_numpy(toks[:, :n_prefill])})
        cache = ServeEngine(model, max_seq=S)._pad_cache(cache)
        for i in range(n_prefill, S):
            logits, cache = model.decode_step(
                torch.from_numpy(toks[:, i:i + 1]), cache)
    rfull, rlogits = np.asarray(rfull), np.asarray(rlogits)
    print(f"{arch} at d_model 320, float32, prefill {n_prefill} + "
          f"{n_decode} decode steps against prefill of {S}, batch 2: max "
          f"|err| reference %.4e, port %.4e (logits up to %.4f); port vs "
          f"reference, full prefill %.4e, after the decode steps %.4e"
          % (np.abs(rlogits - rfull).max(),
             float((logits - full).abs().max()), np.abs(rfull).max(),
             np.abs(full.numpy() - rfull).max(),
             np.abs(logits.numpy() - rlogits).max()))


if __name__ == "__main__":
    gradients()
    invariant()
