"""The port's serving path against the reference's: ``ServeEngine.
generate`` (greedy tokens equal, with left padding, eos, ragged
``max_new`` and writes past ``max_seq``), the analytics scans through
both engines, KV sessions parked by one package and resumed by the
other bit-equal, and the serve launcher.  Float32 smoke models with the
reference's params; JAX is imported inside the tests."""

import re

import numpy as np
import pytest
import torch

from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.core import format as pt_fmt
from repro_torch.core import make_store
from repro_torch.launch import serve as pt_launch
from repro_torch.models import transformer as pt_tr
from repro_torch.models.archs import build_model
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_checkpoint import make_store_from, ref_store_from

ARCH = "yi_9b"


@pytest.fixture(autouse=True)
def cpu_decode():
    from repro.core import format as ref_fmt
    pt_mode = pt_fmt.get_bitunpack_backend()
    ref_fmt.set_bitunpack_backend("numpy")
    pt_fmt.set_bitunpack_backend("plain")
    yield
    ref_fmt.set_bitunpack_backend("auto")
    pt_fmt.set_bitunpack_backend(pt_mode)


def _engines(max_seq, ref_store=None, pt_store=None, arch=ARCH):
    """The reference's engine over its smoke model and params, and the
    port's over the same params on the CPU."""
    import jax

    from repro.configs import base as ref_base
    from repro.models.archs import build_model as ref_build
    from repro.serve.engine import ServeEngine as RefEngine
    rmodel = ref_build(ref_base.get_config(arch, smoke=True), remat="none")
    params = rmodel.init(jax.random.PRNGKey(2))
    model = build_model(get_config(arch, smoke=True), device="cpu")
    pt_tr.params_from_reference(model, jax.device_get(params))
    return (RefEngine(rmodel, params, max_seq=max_seq, store=ref_store),
            ServeEngine(model, max_seq=max_seq, store=pt_store))


def _pt_requests(lengths, max_new, eos=None, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]
    max_new = [max_new] * len(lengths) if isinstance(max_new, int) \
        else max_new
    eos = eos or [None] * len(lengths)
    return [Request(p, m, e) for p, m, e in zip(prompts, max_new, eos)]


def _requests(*args, **kw):
    """The same requests for the reference's engine and the port's."""
    from repro.serve.engine import Request as RefRequest
    preqs = _pt_requests(*args, **kw)
    return ([RefRequest(r.prompt.copy(), r.max_new, r.eos_id)
             for r in preqs], preqs)


def _raw(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return pytree.to_bytes(x)
    return np.ascontiguousarray(np.asarray(x)).tobytes()


CASES = {
    # lengths, max_new per request, max_seq
    "one": ([6], 5, 64),
    "left_pad": ([3, 12, 7, 9], 6, 64),
    "ragged_max_new": ([5, 8, 2], [1, 7, 4], 64),
    # 12 + 10 > 16: decode writes past the last slot, which the
    # reference clamps to slot 15
    "past_max_seq": ([12, 4], 10, 16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_equals_reference(case):
    lengths, max_new, max_seq = CASES[case]
    ref, pt = _engines(max_seq)
    rreqs, preqs = _requests(lengths, max_new)
    want = ref.generate(rreqs)
    got = pt.generate(preqs)
    assert [c.steps for c in got] == [c.steps for c in want]
    for g, w in zip(got, want):
        assert g.tokens.dtype == np.int32
        assert np.array_equal(g.tokens, w.tokens)
    last, rlast = pt._last_cache, ref._last_cache
    assert int(last["pos"]) == int(rlast["pos"])
    for k in ("k", "v"):
        assert last[k].shape[2] == max_seq
        np.testing.assert_allclose(last[k].numpy(), np.asarray(rlast[k]),
                                   rtol=1e-4, atol=1e-4)
    if case == "past_max_seq":
        assert int(last["pos"]) > max_seq


def test_generate_stops_at_eos_like_reference():
    ref, pt = _engines(64)
    rreqs, _ = _requests([4, 9, 6], 8)
    plain = ref.generate(rreqs)
    # each request stops at the token it would emit third, or first
    eos = [int(plain[0].tokens[2]), int(plain[1].tokens[0]), 10_000]
    rreqs, preqs = _requests([4, 9, 6], 8, eos=eos)
    want, got = ref.generate(rreqs), pt.generate(preqs)
    assert [c.steps for c in got] == [c.steps for c in want]
    assert got[1].steps == 1 and got[0].steps <= 3 and got[2].steps == 8
    for g, w in zip(got, want):
        assert np.array_equal(g.tokens, w.tokens)
    assert pt.generate([]) == []
    with pytest.raises(RuntimeError, match="no store"):
        pt.park_session("s")


def _request_log(rng, n):
    return {"latency_ms": rng.gamma(3, 12, n).astype(np.float32),
            "tokens_out": rng.integers(1, 512, n).astype(np.int32),
            "model_id": rng.integers(0, 4, n).astype(np.int32)}


def _log_ds(core, n):
    return core.LogicalDataset(
        "reqlog", (core.Column("latency_ms", "float32"),
                   core.Column("tokens_out", "int32"),
                   core.Column("model_id", "int32")),
        n_rows=n, unit_rows=1024)


@pytest.mark.parametrize("window_s", [None, 0.02], ids=["direct", "session"])
def test_analytics_equal_through_both_engines(window_s):
    import threading

    import repro.core as ref_core
    import repro_torch.core as pt_core
    n = 50_000
    table = _request_log(np.random.default_rng(7), n)
    rs, ps = ref_core.make_store(6, replicas=2), make_store(6, replicas=2)
    ref, pt = _engines(64, rs, ps)
    results = {}
    for name, core, store, eng in (("ref", ref_core, rs, ref),
                                   ("pt", pt_core, ps, pt)):
        vol = core.GlobalVOL(store)
        omap = vol.create(_log_ds(core, n),
                          core.PartitionPolicy(target_object_bytes=64 << 10))
        vol.write(omap, table)
        if window_s is not None:
            eng.attach_analytics(vol, window_s=window_s)
        out = [None] * 4
        bar = threading.Barrier(4)

        def client(i, vol=vol, eng=eng, out=out, bar=bar):
            bar.wait(timeout=30)
            out[i] = eng.analytics(
                vol.scan("reqlog").filter("latency_ms", ">", 100.0)
                .agg("count", "tokens_out").agg("sum", "tokens_out"))[0]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        results[name] = out
        if window_s is not None:
            st = eng.analytics_session.stats
            assert st["admitted"] == 4
            assert st["executed"] + st["deduped"] == 4
    m = table["latency_ms"] > 100.0
    want = {"count(tokens_out)": float(m.sum()),
            "sum(tokens_out)": float(table["tokens_out"][m].sum())}
    assert results["pt"] == results["ref"] == [want] * 4
    for s in (rs, ps):
        s.close()


def test_kv_sessions_move_between_packages_bit_equal():
    import repro.core as ref_core
    rs, ps = ref_core.make_store(4, replicas=2), make_store(4, replicas=2)
    ref, pt = _engines(40, rs, ps)
    rreqs, preqs = _requests([5, 9, 3], 6, seed=3)
    ref.generate(rreqs)
    pt.generate(preqs)
    ref.park_session("from-ref")
    pt.park_session("from-pt")
    assert sorted(ps.list_objects("kv/from-pt/")) == sorted(
        n.replace("from-ref", "from-pt")
        for n in rs.list_objects("kv/from-ref/"))
    # the reference's session resumed by the port, and the port's by the
    # reference, into each one's own cache shapes
    _, pt2 = _engines(40, None, make_store_from(rs))
    got = pt2.resume_session("from-ref", batch=3)
    ref2, _ = _engines(40, ref_store_from(ps), None)
    back = ref2.resume_session("from-pt", batch=3)
    for key in ("k", "v", "pos"):
        assert got[key].dtype == pt._last_cache[key].dtype
        assert _raw(got[key]) == _raw(ref._last_cache[key]), key
        assert _raw(back[key]) == _raw(pt._last_cache[key]), key
        assert _raw(pt.resume_session("from-pt", 3)[key]) == \
            _raw(pt._last_cache[key]), key
    for s in (rs, ps):
        s.close()


def _q8_engine(monkeypatch, quant: bool, store=None, max_seq=48):
    """The port's engine over yi_9b's smoke model (seeded weights), the
    port's int8 KV cache on or off, recording each step's logits."""
    monkeypatch.setattr(pt_tr, "KV_CACHE_QUANT", quant)
    model = build_model(get_config(ARCH, smoke=True), device="cpu")
    model.init(torch.Generator().manual_seed(5))
    eng = ServeEngine(model, max_seq=max_seq, store=store)
    seen = []
    prefill, decode = eng._prefill, eng._decode

    def rec(fn):
        def run(*args):
            logits, cache = fn(*args)
            seen.append(logits.clone())
            return logits, cache
        return run
    eng._prefill, eng._decode = rec(prefill), rec(decode)
    return eng, seen


def test_q8_generate_matches_float_generate(monkeypatch):
    """The int8 KV cache serves through the engine (its scales grow to
    ``max_seq`` with ``k`` / ``v``, which the reference's engine does
    not do, so it cannot decode q8 there): every step's logits within
    5% of the float cache's largest, as the reference's
    ``tests/test_models.py`` holds its q8 decode, and the same tokens."""
    reqs = _pt_requests([7, 12, 4], 10, seed=4)
    f32, want = _q8_engine(monkeypatch, False)
    want_toks = f32.generate(reqs)
    q8, got = _q8_engine(monkeypatch, True)
    got_toks = q8.generate(reqs)
    cache = q8._last_cache
    assert cache["k"].dtype == torch.int8
    for key in ("k", "v", "k_scale", "v_scale"):
        assert cache[key].shape[2] == 48, key
    assert len(got) == len(want) == 10
    for i, (g, w) in enumerate(zip(got, want)):
        rel = float((g - w).abs().max() / w.abs().max())
        assert rel < 0.05, (i, rel)
    for g, w in zip(got_toks, want_toks):
        assert np.array_equal(g.tokens, w.tokens)


def test_q8_session_parks_and_resumes(monkeypatch):
    """A q8 session parked (``k`` / ``v`` and their scales paged on the
    sequence axis) resumes bit-equal, and decodes on as the live cache
    does."""
    store = make_store(4, replicas=2)
    try:
        eng, _ = _q8_engine(monkeypatch, True, store)
        eng.generate(_pt_requests([5, 9, 3], 6, seed=3))
        live = eng._last_cache
        eng.park_session("q8")
        manifest = [n for n in store.list_objects("kv/q8/")
                    if n.endswith("/p00000000")]
        assert len(manifest) == 4       # k, v, k_scale, v_scale paged
        back = eng.resume_session("q8", batch=3)
        assert sorted(back) == sorted(live)
        for key in live:
            assert back[key].dtype == live[key].dtype, key
            assert _raw(back[key]) == _raw(live[key]), key
        tok = torch.tensor([[3], [4], [5]], dtype=torch.int32)
        with torch.inference_mode():
            a, _ = eng.model.decode_step(tok, {k: v.clone()
                                               for k, v in live.items()})
            b, _ = eng.model.decode_step(tok, back)
        assert torch.equal(a, b)
    finally:
        store.close()


def _strip_times(text: str) -> list[str]:
    return [re.sub(r"\d+ ms \([\d.]+ tok/s\)", "<t>", line)
            for line in text.strip().splitlines()]


def test_launcher_prints_what_the_reference_prints(capsys, monkeypatch):
    from repro.launch import serve as ref_launch
    argv = ["--arch", "yi_9b", "--smoke", "--batch", "3", "--max-new", "5"]
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    ref_launch.main()
    want = capsys.readouterr().out
    pt_launch.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _strip_times(got) == _strip_times(want)
    assert got.startswith("[serve] 3 reqs, 15 tokens, ")
    with pytest.raises(SystemExit, match="frontend-stub"):
        pt_launch.main(["--arch", "musicgen_large", "--smoke",
                        "--device", "cpu"])


# ----------------------------------------------------------- on the card
@pytest.mark.gpu
def test_smoke_model_on_the_card_equals_cpu():
    """yi_9b's smoke model with the same weights on the card and on the
    CPU: prefill and decode logits, and the served tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config(ARCH, smoke=True)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    card = build_model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32))
    with torch.inference_mode():
        want, wc = cpu.prefill({"tokens": toks[:, :40]})
        got, gc = card.prefill({"tokens": toks[:, :40].cuda()})
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        wc = ServeEngine(cpu, max_seq=48)._pad_cache(wc)
        gc = ServeEngine(card, max_seq=48)._pad_cache(gc)
        for t in range(4):
            nxt = toks[:, 40 + t:41 + t]
            want, wc = cpu.decode_step(nxt, wc)
            got, gc = card.decode_step(nxt.cuda(), gc)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    preqs = _pt_requests([7, 30, 16], 12)
    want = ServeEngine(cpu, max_seq=64).generate(preqs)
    got = ServeEngine(card, max_seq=64).generate(preqs)
    for g, w in zip(got, want):
        assert np.array_equal(g.tokens, w.tokens)
