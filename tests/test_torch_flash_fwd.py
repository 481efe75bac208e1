"""The inference attention kernel ``kernels.flash_fwd`` and its route.

On the CPU: the block loop's KV-head mapping, which the kernel holds
to, the operator's refusals, the bound's FLOP count, the route rule of
``attention.flash_attention`` (fake CUDA tensors: the operator is
dispatched where the rule holds, the loop everywhere else), the
operator's fake implementation, the dry run's FLOP formula against the
loop's products, the recorder's counters and the benchmark's reader of
them.  On the card (``-m gpu``): the kernel against the loop in bf16 at
the serving cell's shape and at the edges (G = 1, ``q_offset`` > 0 with
Sq < Sk, not causal), its launch count, and the dry run's prefill on
fake CUDA tensors.

Tolerance, the kernel against the loop: both are bf16 roundings of
float32 computations that round P to bf16 against another running
maximum (the loop's 512-key blocks, the kernel's 128-key tiles) and add
in another order, so they differ by a rounding of P and one of the
output: within two bf16 steps of the value (``rtol`` 2^-6) and 2^-8
absolute for outputs near 0 (``atol``).

No JAX here: the card's tests run where JAX is not installed."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from perfbench import harness
from repro_torch import obs
from repro_torch.kernels import flash_fwd as ff
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models import attention

ROOT = Path(__file__).resolve().parent.parent
TOL = {"rtol": 2.0 ** -6, "atol": 2.0 ** -8}
BF16 = torch.bfloat16

# (B, Sq, Sk, H, K, causal, q_offset)
CARD_SHAPES = {"cell": (32, 2048, 2048, 36, 4, True, 0),
               "g1": (2, 1024, 1024, 8, 8, True, 0),
               "offset": (2, 512, 1536, 8, 2, True, 1024),
               "offset_ragged": (1, 200, 700, 4, 2, True, 333),
               "not_causal": (2, 512, 1024, 8, 2, False, 0)}


def _qkv(shape, device="cpu", seed=0, dtype=BF16):
    B, Sq, Sk, H, K, _, _ = shape
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device=device).to(dtype)
                 for s in ((B, Sq, H, 128), (B, Sk, K, 128),
                           (B, Sk, K, 128)))


def _loop(q, k, v, causal, q_offset):
    Sq, Sk = q.shape[1], k.shape[1]
    bq, bk = min(attention.FLASH_BLOCK, Sq), min(attention.FLASH_BLOCK, Sk)
    return attention._flash_fwd(q, k, v, causal, q_offset, bq, bk)[0]


class _Ops(TorchDispatchMode):
    """The names of the operators dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func._schema.name)
        return func(*args, **(kwargs or {}))


def _fake(shape, device="cuda", dtype=BF16, hd=128, hdv=128):
    B, Sq, Sk, H, K, _, _ = shape
    return (torch.empty(B, Sq, H, hd, dtype=dtype, device=device),
            torch.empty(B, Sk, K, hd, dtype=dtype, device=device),
            torch.empty(B, Sk, K, hdv, dtype=dtype, device=device))


# --------------------------------------------------------------------------
# the operator off the card, the loop's head mapping, the bound
# --------------------------------------------------------------------------


@pytest.mark.parametrize("H, K", [(6, 2), (6, 3), (6, 1), (4, 4)])
def test_the_loop_reads_kv_head_h_over_g(H, K):
    """The mapping the kernel holds to: query heads 0..G-1 read KV head
    0, G..2G-1 KV head 1, with G = H / K: each query head alone against
    its KV head gives the same rows."""
    G = H // K
    q, k, v = _qkv((1, 64, 64, H, K, True, 0), seed=3)
    out = _loop(q, k, v, True, 0)
    for h in range(H):
        kv = slice(h // G, h // G + 1)
        one = _loop(q[:, :, h:h + 1], k[:, :, kv], v[:, :, kv], True, 0)
        torch.testing.assert_close(out[:, :, h:h + 1], one, rtol=0, atol=0)


@pytest.mark.parametrize("bad, exc", [
    (lambda q, k, v: (q.float(), k, v), TypeError),
    (lambda q, k, v: (q[..., :64], k[..., :64], v[..., :64]), ValueError),
    (lambda q, k, v: (q[:, :, :3], k, v), ValueError),
    (lambda q, k, v: (q, k, v[:, :16]), ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, exc):
    q, k, v = _qkv((1, 32, 32, 4, 2, True, 0))
    with pytest.raises(exc):
        ff.flash_fwd(*bad(q, k, v))
    with pytest.raises(ValueError):
        ff.flash_fwd(q, k, v, q_offset=-1)


def test_cpu_tensors_have_no_kernel():
    """The operator has the kernel and the fake implementation alone:
    the wrapper refuses CPU tensors, and the operator called on them
    finds no CPU kernel."""
    q, k, v = _qkv((1, 32, 32, 4, 2, True, 0))
    with pytest.raises(ValueError, match="device"):
        ff.flash_fwd(q, k, v)
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.flash_fwd(q, k, v, True, 0)


FIRST_CALL = """
import sys
import torch
from torch._library.custom_ops import OPDEFS
from repro_torch.kernels import flash_fwd as ff
q = torch.zeros(1, 128, 2, 128, dtype=torch.bfloat16, device="meta")
with torch.inference_mode():
    out = ff.flash_fwd(q, q[:, :, :1], q[:, :, :1])
assert out.shape == q.shape and out.device.type == "meta"
print("repro_torch::flash_fwd" in OPDEFS, "torch._dynamo" in sys.modules)
"""


def test_the_operator_is_no_custom_op_and_imports_no_compiler():
    """The operator is a ``torch.library.Library`` definition, not a
    ``custom_op``: a custom op's backend function imports
    ``torch._dynamo`` on its first call, seconds of a serving process's
    set-up.  Its first call (on meta tensors here) imports none."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", FIRST_CALL], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().splitlines()[-1] == "False False"


@pytest.mark.parametrize("shape", [(2, 256, 256, 4, 2, True, 0),
                                   (1, 100, 300, 2, 1, True, 37),
                                   (1, 200, 330, 4, 2, False, 0)], ids=str)
def test_causal_flops_count_the_pairs_the_mask_keeps(shape):
    """The bound's FLOPs: 4 * 128 a (query, key) pair the mask keeps,
    over the batch and the query heads."""
    B, Sq, Sk, H, _, causal, q_offset = shape
    keep = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        keep = (torch.arange(Sk)[None]
                <= q_offset + torch.arange(Sq)[:, None])
    want = 4 * B * H * 128 * int(keep.sum())
    assert ff.causal_flops(B, Sq, Sk, H, causal, q_offset) == want
    assert ff.bound_ms(B, Sq, Sk, H, causal, q_offset) == pytest.approx(
        want / 989e12 * 1e3)


# --------------------------------------------------------------------------
# the route
# --------------------------------------------------------------------------


def test_route_rule_holds_only_for_inference_in_bf16_on_the_card():
    shape = (1, 512, 512, 4, 2, True, 0)
    with FakeTensorMode():
        q, k, v = _fake(shape)
        with torch.no_grad():
            assert attention._kernel_route(q, k, v, 0, None)
            assert not attention._kernel_route(q, k, v, 0, tp=object())
            assert not attention._kernel_route(q, k, v, -1, None)
            f32 = _fake(shape, dtype=torch.float32)
            assert not attention._kernel_route(*f32, 0, None)
            assert not attention._kernel_route(*_fake(shape, hd=64, hdv=64),
                                               0, None)
            assert not attention._kernel_route(*_fake(shape, hd=192), 0, None)
            assert not attention._kernel_route(*_fake(shape, device="cpu"),
                                               0, None)
        with torch.inference_mode():
            assert attention._kernel_route(q, k, v, 0, None)
        with torch.enable_grad():
            assert not attention._kernel_route(q, k, v, 0, None)


@pytest.mark.parametrize("impl", ["vjp", "scan"])
def test_inference_on_fake_cuda_tensors_dispatches_the_operator(impl):
    shape = (2, 1024, 1024, 8, 2, True, 0)
    with FakeTensorMode():
        q, k, v = _fake(shape)
        with torch.no_grad(), _Ops() as ops:
            out = attention.flash_attention(q, k, v, impl=impl)
    assert ops.names.count("repro_torch::flash_fwd") == 1
    assert not any("bmm" in n or "exp" in n for n in ops.names)
    assert out.shape == q.shape and out.dtype == BF16


@pytest.mark.parametrize("grad", [False, True])
def test_the_cpu_keeps_the_loop(grad, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel's route was taken")

    monkeypatch.setattr(attention._ff, "flash_fwd", refuse)
    shape = (1, 128, 128, 4, 2, True, 0)
    q, k, v = _qkv(shape)
    with torch.set_grad_enabled(grad):
        out = attention.flash_attention(q, k, v)
    torch.testing.assert_close(out, _loop(q, k, v, True, 0), rtol=0, atol=0)


def test_unknown_impl_raises_before_any_route():
    with FakeTensorMode():
        q, k, v = _fake((1, 128, 128, 4, 2, True, 0))
        with torch.no_grad(), pytest.raises(ValueError, match="impl"):
            attention.flash_attention(q, k, v, impl="other")


# --------------------------------------------------------------------------
# the fake implementation and the dry run's count
# --------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cuda", "meta"])
def test_fake_implementation_gives_shape_and_dtype(device):
    shape = (3, 200, 600, 6, 3, True, 100)
    before = ff.launches
    with FakeTensorMode():
        q, k, v = _fake(shape, device=device)
        out = ff.flash_fwd(q, k, v, causal=True, q_offset=100)
    assert out.shape == (3, 200, 6, 128) and out.dtype == BF16
    assert out.device.type == device
    assert ff.launches == before


@pytest.mark.parametrize("shape", [(2, 2048, 2048, 36, 4, True, 0),
                                   (1, 1024, 1536, 8, 2, True, 512),
                                   (2, 512, 1024, 4, 2, False, 0),
                                   (1, 100, 100, 4, 1, True, 0)], ids=str)
def test_flop_formula_equals_the_loops_products(shape):
    """The dry run's FLOPs of the operator (fake CUDA tensors, no
    gradient) equal those of the loop it stands in for (fake CPU
    tensors), and the formula is the causal half plus the diagonal
    blocks' other half."""
    causal, q_offset = shape[5:]
    flops = {}
    for device in ("cuda", "cpu"):
        with FakeTensorMode():
            q, k, v = _fake(shape, device=device)
            counter = OpCounter()
            with torch.no_grad(), counter:
                attention.flash_attention(q, k, v, causal=causal,
                                          q_offset=q_offset)
        flops[device] = counter.flops
    assert flops["cuda"] == flops["cpu"] > 0
    assert flops["cuda"] >= ff.causal_flops(*shape[:4], causal, q_offset)


# --------------------------------------------------------------------------
# the counters and the benchmark's reader
# --------------------------------------------------------------------------


@pytest.fixture()
def recorder():
    obs.clear()
    with obs.recording():
        yield
    obs.clear()


def _totals():
    out = {"attn.flash": 0.0, "attn.flash_kernel": 0.0}
    for c in obs.counts():
        if c.name in out:
            out[c.name] += c.value
    return out


def test_counters_count_every_call_and_the_kernels(recorder):
    shape = (1, 128, 128, 4, 2, True, 0)
    q, k, v = _qkv(shape)
    attention.flash_attention(q, k, v)
    with FakeTensorMode():
        fq, fk, fv = _fake(shape)
        with torch.no_grad():
            attention.flash_attention(fq, fk, fv)
            attention.flash_attention(fq, fk, fv)
    assert _totals() == {"attn.flash": 3.0, "attn.flash_kernel": 2.0}


def test_counters_are_off_without_a_recorder():
    obs.clear()
    q, k, v = _qkv((1, 64, 64, 2, 1, True, 0))
    attention.flash_attention(q, k, v)
    assert not obs.counts()


class _Run:
    window = (10.0, 20.0)


def _count(name, at, value):
    obs._records.append(obs.Count(name, int(at * 1e9), None, 0, value))


def _reader():
    return harness.load_reader(ROOT, "flash_kernel_share.prefill")


@pytest.mark.parametrize("records, want", [
    ([], None),
    ([("attn.flash", 5.0, 3), ("attn.flash_kernel", 5.0, 3)], None),
    ([("attn.flash", 11.0, 32), ("attn.flash_kernel", 11.0, 32)], 100.0),
    ([("attn.flash", 11.0, 32), ("attn.flash", 12.0, 32),
      ("attn.flash_kernel", 12.0, 32), ("attn.flash_kernel", 25.0, 9)],
     50.0),
    ([("attn.flash", 11.0, 4)], 0.0),
])
def test_reader_share_inside_the_window(records, want, recorder):
    for name, at, value in records:
        _count(name, at, value)
    got = _reader()(_Run())
    assert got == (None if want is None else pytest.approx(want))


def test_reader_is_none_without_the_programs_recorder(monkeypatch):
    monkeypatch.delitem(sys.modules, "repro_torch.obs")
    assert _reader()(_Run()) is None


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_kernel_matches_the_loop_on_the_card(card, name):
    shape = CARD_SHAPES[name]
    causal, q_offset = shape[5:]
    q, k, v = _qkv(shape, device=card, seed=7)
    before = ff.launches
    got = ff.flash_fwd(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize(card)
    assert ff.launches == before + 1
    with torch.no_grad():
        want = _loop(q, k, v, causal, q_offset)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.gpu
def test_flash_attention_takes_the_kernel_for_inference_only(card):
    shape = (2, 512, 512, 8, 2, True, 0)
    q, k, v = _qkv(shape, device=card, seed=8)
    before = ff.launches
    with torch.inference_mode():
        got = attention.flash_attention(q, k, v)
    assert ff.launches == before + 1
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    want = attention.flash_attention(q, k, v)
    want.float().sum().backward()
    assert ff.launches == before + 1 and q.grad is not None
    torch.testing.assert_close(got.float(), want.detach().float(), **TOL)


DRYRUN = """
import json, sys
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as dr
from repro_torch.kernels import flash_fwd as ff
out = {}
for device in ("cuda", "cpu"):
    rec = dr.run_cell("yi_9b", "prefill_32k", multi_pod=False,
                      device=device, mesh_shape=(1, 1),
                      shape=ShapeSpec("p", 1024, 2, "prefill"))
    out[device] = [rec["ok"], rec["hlo_flops_per_dev"]]
out["launches"] = ff.launches
print(json.dumps(out))
"""


@pytest.mark.gpu
def test_dry_run_prefill_on_fake_cuda_tensors(card, tmp_path):
    """The dry run's prefill of yi_9b (bf16, heads of 128) on fake CUDA
    tensors reaches the operator's fake implementation (fake CUDA
    tensors need PyTorch built with CUDA) and counts the FLOPs of the
    same cell on fake CPU tensors, which take the loop."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(DRYRUN)],
                         env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["cuda"][0] and out["cpu"][0]
    assert out["cuda"][1] == out["cpu"][1] > 0
    assert out["launches"] == 0
