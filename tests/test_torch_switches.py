"""The reference's two module switches in the port, single process: the
mixed product (bf16 operands, a float32 result: ``preferred_element_
type=jnp.float32``) that ``layers.XENT_MM = "mixed"`` (the reference's
default) and the attention and SSD products use, and ``"cast"``.

``layers.mixed_einsum`` on a CPU tensor is the plain version (both
operands upcast, one float32 einsum), held here bit for bit; its card
route (one ``aten::bmm.dtype``) is held here for its layout (``as_bmm``
through a float32 ``bmm``) and its backward products (``mixed_bmm_
grads`` against autograd of the upcast product), and on the card by
``chip_smoke.py`` and the ``gpu`` test below.  Every input is drawn
with numpy from a fixed seed and rounded to bf16; the reference runs
its bf16 arrays, the port its bf16 tensors.

The ``"mixed"`` loss (the reference's default, in this process: no
reference global is patched) and its gradients of ``hidden`` and
``head`` are held at ``tests/test_torch_train.py``'s ``MODEL_TOL``
(rtol / atol 1e-4).  ``"cast"`` is flipped in the reference only in a
``_multirank._reference`` subprocess, and in the port's own module.
The flash forward and backward, the GQA, int8 and MLA decodes and the
SSD at bf16: float32 results at ``MODEL_TOL``, bf16 results (the
flash output and gradients, the decodes' outputs) within one bf16
rounding step (``BF16_STEP``, 2^-7 of the value) or half a step of the
tensor's largest entry (``_close_bf16``): the two sides sum their
float32 products in different orders, a last-bit difference can round
a bf16 result either way, and a flipped bf16 output moves the flash
backward's D = rowsum(dout * out) and with it every gradient (measured:
at most 1.6e-3 of the largest entry)."""

import numpy as np
import pytest
import torch
from _multirank import _reference
from _threads import few_torch_threads  # noqa: F401

from repro_torch.configs import get_config
from repro_torch.models import attention as pt_attn
from repro_torch.models import layers as pt_layers
from repro_torch.models import ssm as pt_ssm
from repro_torch.models import transformer as pt_tr

MODEL_TOL = {"rtol": 1e-4, "atol": 1e-4}   # tests/test_torch_train.py
BF16_STEP = 2.0 ** -7       # one bf16 rounding step, of the value at most
CORE = -7                   # the multi-rank files take the last six
# every mixed product of the port, with its operands' shapes
SPECS = {"bqhd,bkhd->bhqk": ((2, 8, 4, 16), (2, 8, 4, 16)),
         "bhqk,bkhd->bhqd": ((2, 4, 8, 8), (2, 8, 4, 16)),
         "bkgd,bskd->bkgs": ((3, 2, 2, 16), (3, 12, 2, 16)),
         "bhr,bsr->bhs": ((3, 4, 32), (3, 12, 32)),
         "bhp,bsp->bhs": ((3, 4, 8), (3, 12, 8)),
         "bkgs,bskd->bkgd": ((3, 2, 2, 12), (3, 12, 2, 16)),
         "btn,bsn->bts": ((2, 16, 8), (2, 16, 8)),
         "bcd,dv->bcv": ((2, 16, 32), (32, 96))}


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, held as float32 (exact)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _j(a):
    import jax.numpy as jnp
    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, msg="") -> None:
    np.testing.assert_allclose(_np(got), _np(want), **tol, err_msg=msg)


def _close_bf16(got, want, msg="") -> None:
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=BF16_STEP,
                               atol=BF16_STEP / 2 * np.abs(w).max(),
                               err_msg=msg)


def _operands(spec, seed):
    rng = np.random.default_rng(seed)
    return [_t(rng.normal(size=s)) for s in SPECS[spec]]


# ---------------------------------------------------- the product itself
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_mixed_product_on_the_cpu_is_the_upcast_product(spec):
    """Bit for bit, forward and the bf16 gradients."""
    a, b = (x.requires_grad_() for x in _operands(spec, 1))
    got = pt_layers.mixed_einsum(spec, a, b)
    want = torch.einsum(spec, a.detach().float(), b.detach().float())
    assert got.dtype == torch.float32 and torch.equal(got, want)
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=tuple(got.shape)).astype(np.float32))
    ga, gb = torch.autograd.grad(got, (a, b), g)
    af, bf = (x.detach().float().requires_grad_() for x in (a, b))
    wa, wb = torch.autograd.grad(torch.einsum(spec, af, bf), (af, bf), g)
    assert ga.dtype == gb.dtype == torch.bfloat16
    assert torch.equal(ga, wa.to(torch.bfloat16))
    assert torch.equal(gb, wb.to(torch.bfloat16))


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_card_route_lays_the_product_out_as_einsum(spec):
    """The card route's one batched product (``as_bmm``), through a
    float32 ``bmm`` here, is the einsum; its backward products
    (``mixed_bmm_grads``) are autograd's of the upcast product."""
    a, b = _operands(spec, 3)
    bmm_in = []

    def bmm(x, y):
        bmm_in.append((x, y))
        return torch.bmm(x.float(), y.float())

    got = pt_layers.as_bmm(spec, a, b, bmm)
    want = torch.einsum(spec, a.float(), b.float())
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    (x, y), = bmm_in
    assert x.dtype == y.dtype == torch.bfloat16 and x.ndim == y.ndim == 3
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=(x.shape[0], x.shape[1], y.shape[2])).astype(np.float32))
    ga, gb = pt_layers.mixed_bmm_grads(x, y, g)
    xf, yf = (t.float().requires_grad_() for t in (x, y))
    wa, wb = torch.autograd.grad(torch.bmm(xf, yf), (xf, yf), g)
    assert ga.dtype == gb.dtype == torch.bfloat16
    assert torch.equal(ga, wa.to(torch.bfloat16))
    assert torch.equal(gb, wb.to(torch.bfloat16))
    assert pt_layers.mixed_bmm_grads(x, y, g, (False, True))[0] is None


def test_mixed_product_refuses_what_one_bmm_cannot_do():
    with pytest.raises(ValueError, match="one batched product"):
        pt_layers._bmm_plan("bij,bjk->bi")


@pytest.mark.gpu
def test_mixed_product_on_the_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    for spec in SPECS:
        a, b = _operands(spec, 5)
        want = pt_layers.mixed_einsum(spec, a, b)
        ac, bc = (x.to(dev).requires_grad_() for x in (a, b))
        got = pt_layers.mixed_einsum(spec, ac, bc)
        assert got.dtype == torch.float32 and got.device == dev
        _close(got.cpu(), want, {"rtol": 1e-5, "atol": 1e-5}, spec)
        ga, gb = torch.autograd.grad(got, (ac, bc), torch.ones_like(got))
        assert ga.dtype == gb.dtype == torch.bfloat16


# ------------------------------------------------------- the head product
def _xent_inputs(seed=6, S=64):
    rng = np.random.default_rng(seed)
    h = _bf16(rng.normal(size=(2, S, 32)))
    head = _bf16(rng.normal(size=(32, 96)) * 0.3)
    lab = rng.integers(0, 96, (2, S)).astype(np.int32)
    lab[0, :5] = -1                                   # masked positions
    lab[1, -3:] = -1
    return h, head, lab


def _port_xent(h, head, lab, chunk):
    th, thead = _t(h).requires_grad_(), _t(head).requires_grad_()
    loss, m = pt_layers.chunked_softmax_xent(th, thead, torch.from_numpy(lab),
                                             chunk=chunk)
    g = torch.autograd.grad(loss, (th, thead))
    return loss, m, g


@pytest.mark.parametrize("chunk", [16, 1024], ids=["4chunks", "1chunk"])
def test_mixed_head_product_equals_reference_default(chunk):
    """bf16 hidden and head: the loss, its metrics and the bf16
    gradients of both, the head's summed over chunks in bf16 as the
    reference's scan sums them."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as ref_layers
    assert ref_layers.XENT_MM == pt_layers.XENT_MM == "mixed"
    h, head, lab = _xent_inputs()

    def f(h, head):
        return ref_layers.chunked_softmax_xent(h, head, jnp.asarray(lab),
                                               chunk=chunk)

    (want, wm), wg = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        _j(h), _j(head))
    loss, m, got = _port_xent(h, head, lab, chunk)
    _close(loss, want, MODEL_TOL)
    for k in ("nll", "accuracy", "tokens"):
        _close(m[k], wm[k], MODEL_TOL, k)
    for g, w in zip(got, wg):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        _close(g, w, MODEL_TOL)


XENT_CAST = """
from repro.models import layers
h, head, lab = (np.load(TMP / "in.npz")[k] for k in ("h", "head", "lab"))
old = layers.XENT_MM
layers.XENT_MM = "cast"
try:
    def f(h, head):
        return layers.chunked_softmax_xent(h, head, jnp.asarray(lab),
                                           chunk=CHUNK)
    (loss, m), (gh, ghead) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(h, jnp.bfloat16),
                                         jnp.asarray(head, jnp.bfloat16))
finally:
    layers.XENT_MM = old
OUT.update(loss=host(loss), nll=host(m["nll"]), gh=host(gh),
           ghead=host(ghead), dtype=np.array(str(gh.dtype)))
"""


def test_cast_head_product_equals_reference_cast(tmp_path, monkeypatch):
    """``XENT_MM = "cast"`` on both sides: the reference's flipped in its
    own subprocess, the port's here."""
    h, head, lab = _xent_inputs(seed=7)
    np.savez(tmp_path / "in.npz", h=h, head=head, lab=lab)
    ref = _reference(XENT_CAST, tmp_path, core=CORE, devices=1, CHUNK=16)
    monkeypatch.setattr(pt_layers, "XENT_MM", "cast")
    loss, m, (gh, ghead) = _port_xent(h, head, lab, 16)
    assert str(ref["dtype"]) == "bfloat16"
    _close(loss, ref["loss"], MODEL_TOL)
    _close(m["nll"], ref["nll"], MODEL_TOL)
    _close(gh, ref["gh"], MODEL_TOL)
    _close(ghead, ref["ghead"], MODEL_TOL)


def test_xent_mm_refuses_an_unknown_mode(monkeypatch):
    monkeypatch.setattr(pt_layers, "XENT_MM", "fp8")
    with pytest.raises(ValueError, match="XENT_MM"):
        pt_layers.head_logits(_t(np.ones((1, 2, 4))), _t(np.ones((4, 3))))


# ------------------------------------------------------- attention at bf16
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("G", [1, 2])
def test_flash_at_bf16_equals_reference(G, causal):
    """Mixed scores and value product forward, mixed recomputed scores
    in the backward (its other four products float32), bf16 out; the
    "scan" route (autograd through the forward) against the reference's
    own "scan"."""
    import jax

    from repro.models import attention as ref_attn
    rng = np.random.default_rng(20 + G)
    B, S, K, hd = 2, 48, 2, 16
    q, k, v, dout = (_bf16(rng.normal(size=s)) for s in (
        (B, S, G * K, hd), (B, S, K, hd), (B, S, K, hd), (B, S, G * K, hd)))
    kw = dict(causal=causal, block_q=16, block_k=16)
    for impl in ("vjp", "scan"):
        want, vjp = jax.vjp(lambda q, k, v: ref_attn.flash_attention(
            q, k, v, impl=impl, **kw), _j(q), _j(k), _j(v))
        wg = vjp(_j(dout))
        tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
        out = pt_attn.flash_attention(tq, tk, tv, impl=impl, **kw)
        got = torch.autograd.grad(out, (tq, tk, tv), _t(dout))
        assert out.dtype == torch.bfloat16
        _close_bf16(out, want, impl)
        for name, g, w in zip("qkv", got, wg):
            assert g.dtype == torch.bfloat16
            _close_bf16(g, w, f"{impl} d{name}")


def _bf16_attn(arch, rng):
    cfg = get_config(arch, smoke=True)
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (d, H, hd), "wk": (d, K, hd), "wv": (d, K, hd),
              "wo": (H, hd, d)}
    p = {k: _bf16(rng.normal(size=s) * pt_tr.fan_in("attn", k, s) ** -0.5)
         for k, s in shapes.items()}
    return cfg, p


def _ref_cfg(arch):
    from repro.configs import base as ref_base
    return ref_base.get_config(arch, smoke=True)


@pytest.mark.parametrize("pos", [5, 15], ids=lambda p: f"pos{p}")
def test_gqa_decode_at_bf16_equals_reference(pos):
    """The mixed score product against a bf16 cache; the value product
    stays bf16, as the reference's."""
    import jax.numpy as jnp

    from repro.models import attention as ref_attn
    rng = np.random.default_rng(30 + pos)
    cfg, p = _bf16_attn("yi_9b", rng)
    K, hd, S = cfg.n_kv_heads, cfg.head_dim, 16
    x = _bf16(rng.normal(size=(3, 1, cfg.d_model)))
    kc, vc = (_bf16(rng.normal(size=(3, S, K, hd))) for _ in "kv")
    got = pt_attn.gqa_decode(cfg, {k: _t(v) for k, v in p.items()}, _t(x),
                             pos, _t(kc), _t(vc))
    want = ref_attn.gqa_decode(_ref_cfg("yi_9b"),
                               {k: _j(v) for k, v in p.items()}, _j(x),
                               jnp.asarray(pos, jnp.int32), _j(kc), _j(vc))
    assert got[0].dtype == torch.bfloat16
    _close_bf16(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, {"rtol": 0, "atol": 0})


@pytest.mark.parametrize("pos", [5, 15], ids=lambda p: f"pos{p}")
def test_gqa_decode_q8_at_bf16_equals_reference(pos):
    """The int8 cache's score product as a mixed product of bf16 q and
    the int8 values in bf16 (exact), the reference's float32 product of
    both upcast; the new token's int8 entries and scales equal."""
    import jax.numpy as jnp

    from repro.models import attention as ref_attn
    rng = np.random.default_rng(40 + pos)
    cfg, p = _bf16_attn("yi_9b", rng)
    K, hd, S = cfg.n_kv_heads, cfg.head_dim, 16
    x = _bf16(rng.normal(size=(2, 1, cfg.d_model)))
    kq, ks = ref_attn.quantize_kv(jnp.asarray(rng.normal(size=(2, S, K, hd)),
                                              jnp.float32))
    vq, vs = ref_attn.quantize_kv(jnp.asarray(rng.normal(size=(2, S, K, hd)),
                                              jnp.float32))
    caches = [np.asarray(a) for a in (kq, vq, ks, vs)]
    got = pt_attn.gqa_decode_q8(cfg, {k: _t(v) for k, v in p.items()}, _t(x),
                                pos, *(torch.from_numpy(c.copy())
                                       for c in caches))
    want = ref_attn.gqa_decode_q8(_ref_cfg("yi_9b"),
                                  {k: _j(v) for k, v in p.items()}, _j(x),
                                  jnp.asarray(pos, jnp.int32),
                                  *map(jnp.asarray, caches))
    assert got[0].dtype == torch.bfloat16
    _close_bf16(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pos", [5, 15], ids=lambda p: f"pos{p}")
def test_mla_decode_at_bf16_equals_reference(pos):
    """Both latent score products mixed, at bf16."""
    import jax.numpy as jnp

    from repro.models import attention as ref_attn
    arch = "deepseek_v2_lite_16b"
    cfg = get_config(arch, smoke=True)
    m, d, H, S = cfg.mla, cfg.d_model, cfg.n_heads, 16
    rng = np.random.default_rng(50 + pos)
    r, nope, rope, vd = (m.kv_lora_rank, m.qk_nope_head_dim,
                         m.qk_rope_head_dim, m.v_head_dim)
    shapes = {"wq": (d, H, nope + rope), "wdkv": (d, r + rope),
              "wuk": (r, H, nope), "wuv": (r, H, vd), "wo": (H, vd, d)}
    p = {k: _bf16(rng.normal(size=s) * (s[0] * (s[1] if k == "wo" else 1))
                  ** -0.5) for k, s in shapes.items()}
    x = _bf16(rng.normal(size=(3, 1, d)))
    ckv, krope = _bf16(rng.normal(size=(3, S, r))), _bf16(
        rng.normal(size=(3, S, rope)))
    got = pt_attn.mla_decode(cfg, {k: _t(v) for k, v in p.items()}, _t(x),
                             pos, _t(ckv), _t(krope))
    want = ref_attn.mla_decode(_ref_cfg(arch),
                               {k: _j(v) for k, v in p.items()}, _j(x),
                               jnp.asarray(pos, jnp.int32), _j(ckv),
                               _j(krope))
    assert got[0].dtype == torch.bfloat16
    _close_bf16(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, {"rtol": 0, "atol": 0})


# ------------------------------------------------------------- SSD at bf16
def test_ssd_at_bf16_equals_reference():
    """Mamba2's chunked SSD (two chunks) on bf16 projections, conv
    weights and input: the mixed ``C.B`` of the bf16 B and C, the other
    products float32, the state float32, the conv's silu step by step as
    XLA computes ``jax.nn.silu`` at bf16."""
    import jax

    from repro.models import ssm as ref_ssm
    arch = "zamba2_2p7b"
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(60)
    p = {}
    for k, t in pt_ssm.init_mamba2(cfg).items():
        s = tuple(t.shape)
        if k in ("dt_bias", "A_log"):
            a = 0.5 * rng.normal(size=s)
        elif k in ("D_skip", "norm_scale"):
            a = 1.0 + 0.2 * rng.normal(size=s)
        else:
            a = rng.normal(size=s) * pt_tr.fan_in("", k, s) ** -0.5
        p[k] = (_bf16(a), t.dtype)
    S = 2 * cfg.ssm.chunk
    x = _bf16(rng.normal(size=(2, S, cfg.d_model)))
    pp = {k: torch.from_numpy(a) if a.ndim < 2 else _t(a)
          for k, (a, _) in p.items()}
    rp = {k: _j(a) if pp[k].dtype == torch.bfloat16 else np.asarray(a)
          for k, (a, _) in p.items()}
    out, st = pt_ssm.mamba2_forward(cfg, pp, _t(x), state_out=True)
    rout, rst = jax.jit(lambda p, x: ref_ssm.mamba2_forward(
        _ref_cfg(arch), p, x, state_out=True))(rp, _j(x))
    assert out.dtype == torch.bfloat16 and st["ssd"].dtype == torch.float32
    _close_bf16(out, rout)
    _close(st["ssd"], rst["ssd"], MODEL_TOL)
