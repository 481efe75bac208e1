"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

1. Prints torch/CUDA versions and the card's name and power limit.
2. Builds the port's CUDA kernel (``csrc/bitunpack.cu``) from this
   checkout and prints nvcc's register/spill report.
3. Holds the kernel bit-exact against its plain PyTorch version on the
   card and against the numpy codec, over a sweep of widths and lengths;
   times it (device time from ``torch.profiler``, time per call from
   CUDA events) beside its memory bound.
4. Drives the port's main path through the user entry points: a 2^28-row
   event table (3 GiB raw, the paper's Table 1 scale) written into an
   8-OSD, 3-replica store with the default 8 MiB objects, then a
   filter -> agg, a filter -> project, a row-range read, an OSD loss,
   recovery and the aggregate again — every bitpack column decoded on
   the card.  Results are checked against numpy on the generated table
   and against the same scans with the numpy decode.

The last line is ``{"ok": true, "device": {...}}``; any failure raises
and the exit code is non-zero.  Needs a CUDA device and a checkout of
the repository.

Run from the root of a checkout:  python3 chip_smoke.py [--rows-log2 N]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FULL_ROWS_LOG2 = 28            # 2^28 rows x 12 B = 3 GiB, the paper's 3 GB
SWEEP_BITS = (1, 5, 7, 8, 13, 16, 17, 20, 24, 31, 32)
SWEEP_N = (0, 1, 31, 32, 33, 129, 1000, 4096, (1 << 24) + 17)


def _load_port():
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, str(root / "src"))
    import repro_torch.core as core
    from repro_torch.core import format as fmt
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import bitunpack as bu
    return core, fmt, bu, ref, _build


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n: int, bits: int) -> float:
    """Least time for one decode: n*bits/8 bytes read + 4n written."""
    return (n * bits / 8 + 4 * n) / HBM_BYTES_PER_S * 1e3


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def traced(fn) -> tuple[float, float]:
    """(device busy ms, host wall s) of one call of ``fn``: the summed
    durations of the kernels and copies ``torch.profiler`` saw on the
    card, and the host clock around the call and a synchronise."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e3, wall


def device_ms(fn, iters: int) -> float:
    """Device time per call of ``fn`` (kernels and copies only, without
    the host's launch overhead), from a profiled run of ``iters`` calls."""
    for _ in range(3):
        fn()

    def loop():
        for _ in range(iters):
            fn()

    busy, _ = traced(loop)
    if busy <= 0:
        raise AssertionError("torch.profiler saw no device time")
    return busy / iters


def _values(rng, bits: int, n: int) -> np.ndarray:
    return rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(np.uint32)


def _words_tensor(words: np.ndarray, bits: int) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)
                            ).reshape(-1, bits)


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------


def kernel_sweep(dev, fmt, bu, ref) -> int:
    """Bit-exact sweep; returns the largest |kernel - plain| seen (0)."""
    rng = np.random.default_rng(0)
    worst = 0
    for bits in SWEEP_BITS:
        for n in SWEEP_N:
            v = _values(rng, bits, n)
            words = fmt.bitpack_encode(v, bits)
            w = _words_tensor(words, bits).to(dev)
            got = bu.bitunpack_groups(w, bits, n)
            plain = bu.bitunpack_plain(w, bits, n)
            torch.cuda.synchronize()
            diff = (got.to(torch.int64) - plain.to(torch.int64)).abs()
            worst = max(worst, int(diff.max()) if n else 0)
            got_np = got.cpu().numpy().view(np.uint32)
            if not (torch.equal(got, plain)
                    and np.array_equal(got_np, fmt.bitpack_decode(
                        words, bits, n))
                    and np.array_equal(got_np, v)):
                raise AssertionError(f"bitunpack differs: bits={bits} n={n}")
        # the host adapter the scan path calls, and the (R, 4, bits) form
        words = fmt.bitpack_encode(_values(rng, bits, 4096 + 5), bits)
        if not np.array_equal(bu.bitunpack_words(words, bits, 4096 + 5),
                              fmt.bitpack_decode(words, bits, 4096 + 5)):
            raise AssertionError(f"bitunpack_words differs: bits={bits}")
        tiles = _words_tensor(fmt.bitpack_encode(
            _values(rng, bits, 128 * 37), bits), bits).reshape(37, 4, bits)
        tiles = tiles.to(dev)
        got = bu.bitunpack(tiles, bits=bits)
        torch.cuda.synchronize()
        if not torch.equal(got, ref.bitunpack_ref(tiles, bits)):
            raise AssertionError(f"bitunpack tiles differ: bits={bits}")
    return worst


def kernel_timing(bu, n: int, bits: int, words: torch.Tensor,
                  iters: int) -> dict:
    """Device time of the kernel and of the plain version (profiler),
    and each one's time per call with the host's launch overhead in it
    (CUDA events around back-to-back calls)."""
    def kernel():
        bu.bitunpack_groups(words, bits, n)

    def plain():
        bu.bitunpack_plain(words, bits, n)

    p_iters = max(1, iters // 10)
    ms, plain_ms = device_ms(kernel, iters), device_ms(plain, p_iters)
    nbytes = n * bits / 8 + 4 * n
    return {"n": n, "bits": bits, "ms": ms, "plain_ms": plain_ms,
            "call_ms": cuda_ms(kernel, iters),
            "plain_call_ms": cuda_ms(plain, p_iters),
            "bound_ms": bound_ms(n, bits), "GB_per_s": nbytes / ms / 1e6}


def object_breakdown(dev, fmt, bu, n: int, bits: int) -> dict:
    """One main-path column decode split into H2D, kernel and D2H."""
    rng = np.random.default_rng(1)
    words = fmt.bitpack_encode(_values(rng, bits, n), bits)
    host = _words_tensor(words, bits).pin_memory()
    back = torch.empty(n, dtype=torch.int32).pin_memory()
    times = {"h2d_ms": [], "kernel_ms": [], "d2h_ms": []}
    for _ in range(23):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        w = host.to(dev, non_blocking=True)
        ev[1].record()
        out = bu.bitunpack_groups(w, bits, n)
        ev[2].record()
        back.copy_(out, non_blocking=True)
        ev[3].record()
        ev[3].synchronize()
        for k, (a, b) in zip(times, zip(ev, ev[1:])):
            times[k].append(a.elapsed_time(b))
    if not np.array_equal(back.numpy().view(np.uint32),
                          fmt.bitpack_decode(words, bits, n)):
        raise AssertionError("object decode differs")
    return {k: float(np.median(v[3:])) for k, v in times.items()}


# --------------------------------------------------------------------------
# main-path phase
# --------------------------------------------------------------------------


def make_events(dev, n: int, seed: int) -> dict[str, np.ndarray]:
    """The event table of the pushdown benchmark, generated on the card."""
    torch.manual_seed(seed)
    run = torch.randint(0, 100, (n,), device=dev, dtype=torch.int32)
    hits = torch.poisson(torch.full((n,), 12.0, device=dev)).to(torch.int32)
    gamma = torch.distributions.Gamma(torch.tensor(2.0, device=dev),
                                      torch.tensor(1 / 20.0, device=dev))
    e_pt = gamma.sample((n,)).to(torch.float32)
    return {"e_pt": e_pt.cpu().numpy(), "run": run.cpu().numpy(),
            "hits": hits.cpu().numpy()}


def _bitpack_cols(store, omap, fmt) -> dict[str, set[str]]:
    """Per object, its bitpack-coded columns (read off the primary's
    disk, outside the fabric)."""
    out = {}
    for name in omap.object_names():
        osd = store.osds[store.cluster.primary(name)]
        with osd.lock:
            blob = osd.data[name]
        out[name] = {c["name"] for c in fmt.block_header(blob)["columns"]
                     if c["codec"].startswith("bitpack")}
    return out


def main_path(dev, core, fmt, bu, rows_log2: int, seed: int) -> dict:
    n = 1 << rows_log2
    t0 = time.perf_counter()
    table = make_events(dev, n, seed)
    gen_s = time.perf_counter() - t0
    store = core.make_store(8, replicas=3)
    try:
        return _drive(core, fmt, bu, store, table, n, gen_s)
    finally:
        store.close()


def _drive(core, fmt, bu, store, table, n, gen_s) -> dict:
    vol = core.GlobalVOL(store)
    ds = core.LogicalDataset(
        "events", (core.Column("e_pt", "float32"), core.Column("run", "int32"),
                   core.Column("hits", "int32")), n, 4096)
    omap = vol.create(ds, core.PartitionPolicy())
    per_obj = len(omap.extents[0])
    r0 = n // 3 + 12_345
    r1 = min(n, r0 + 3 * per_obj // 2)

    def q_agg():
        return (vol.scan("events").filter("run", "<", 50)
                .agg("sum", "e_pt").agg("count", "e_pt").execute())

    def q_project():
        return (vol.scan("events").filter("hits", ">", 20)
                .project("hits", "run").execute())

    def q_rows():
        return vol.read(omap, core.RowRange(r0, r1))

    walls = {}
    fmt.set_bitunpack_backend("device")
    bu.launches = 0                      # the main path's run starts here
    t = time.perf_counter()
    vol.write(omap, table)
    walls["write_s"] = time.perf_counter() - t
    t = time.perf_counter()
    agg, agg_stats = q_agg()
    walls["filter_agg_s"] = time.perf_counter() - t
    t = time.perf_counter()
    proj, proj_stats = q_project()
    walls["filter_project_s"] = time.perf_counter() - t
    t = time.perf_counter()
    rows = q_rows()
    walls["row_read_s"] = time.perf_counter() - t
    victim = store.cluster.primary(omap.object_names()[0])
    store.fail_osd(victim)
    t = time.perf_counter()
    rec = store.recover()
    walls["recover_s"] = time.perf_counter() - t
    t = time.perf_counter()
    agg2, agg2_stats = q_agg()
    walls["filter_agg_after_recover_s"] = time.perf_counter() - t
    launches = bu.launches               # ... and ends here

    # every bitpack column decode the scans asked for, counted from the
    # objects' own headers and the scans' prune counts: the aggregates
    # decode run, the projection hits and run, the read every column
    bp = _bitpack_cols(store, omap, fmt)
    if any(cols != {"run", "hits"} for cols in bp.values()):
        raise AssertionError(f"unexpected codecs: {bp}")
    n_obj = omap.n_objects
    touched = [e for e in omap.extents
               if e.row_start < r1 and e.row_stop > r0]
    expect = ((n_obj - agg_stats["objects_pruned"])
              + 2 * (n_obj - proj_stats["objects_pruned"])
              + 2 * len(touched)
              + (n_obj - agg2_stats["objects_pruned"]))
    if not launches > 0 or launches != expect:
        raise AssertionError(f"bitunpack launches {launches} != bitpack "
                             f"column decodes {expect}")
    if rec["objects_lost"]:
        raise AssertionError(f"recover lost {rec['objects_lost']} objects")

    # against numpy, straight from the generated table
    m = table["run"] < 50
    want_sum = float(table["e_pt"][m].astype(np.float64).sum())
    want_count = float(m.sum())
    for name, got in (("filter_agg", agg), ("after_recover", agg2)):
        if got["count(e_pt)"] != want_count:
            raise AssertionError(f"{name}: count {got['count(e_pt)']} "
                                 f"!= {want_count}")
        if abs(got["sum(e_pt)"] - want_sum) > 1e-9 * abs(want_sum):
            raise AssertionError(f"{name}: sum {got['sum(e_pt)']!r} "
                                 f"!= {want_sum!r} (rel 1e-9)")
    m = table["hits"] > 20
    for k in ("hits", "run"):
        if not np.array_equal(proj[k], table[k][m]):
            raise AssertionError(f"filter_project: column {k} differs")
    for k in ("e_pt", "run", "hits"):
        if not np.array_equal(rows[k], table[k][r0:r1]):
            raise AssertionError(f"row_read: column {k} differs")

    # against the same scans with the numpy decode: exactly equal
    fmt.set_bitunpack_backend("numpy")
    try:
        t = time.perf_counter()
        agg_np, _ = q_agg()
        walls["filter_agg_numpy_decode_s"] = time.perf_counter() - t
        proj_np, _ = q_project()
        rows_np = q_rows()
    finally:
        fmt.set_bitunpack_backend("device")
    if agg_np != agg2:
        raise AssertionError(f"numpy decode agg {agg_np} != {agg2}")
    for k in proj:
        if not np.array_equal(proj_np[k], proj[k]):
            raise AssertionError(f"numpy decode project: {k} differs")
    for k in rows:
        if not np.array_equal(rows_np[k], rows[k]):
            raise AssertionError(f"numpy decode rows: {k} differs")
    # one more filter -> agg under the profiler: how busy the card is
    busy_ms, traced_s = traced(q_agg)
    f = store.fabric.snapshot()
    return {"rows": n, "objects": n_obj, "rows_per_object": per_obj,
            "generate_s": gen_s, **walls, "launches": launches,
            "bitpack_decodes": expect, "sum_e_pt": agg["sum(e_pt)"],
            "count": agg["count(e_pt)"], "projected_rows": int(m.sum()),
            "read_rows": r1 - r0, "recovered": rec["objects_moved"],
            "victim": victim, "fabric_ops": f["ops"],
            "client_rx": f["client_rx"],
            "traced_filter_agg_s": traced_s,
            "traced_filter_agg_device_busy_ms": busy_ms,
            "traced_filter_agg_device_busy_share": busy_ms / 1e3 / traced_s}


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows-log2", type=int, default=FULL_ROWS_LOG2,
                    help="main-path table rows as a power of two")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    core, fmt, bu, ref, _build = _load_port()
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"card: {card}", flush=True)

    t = time.perf_counter()
    bu.ensure_built()
    info = _build.build_info["bitunpack"]
    print(f"build: bitunpack {info['seconds']:.2f}s nvcc, "
          f"{time.perf_counter() - t:.2f}s with load", flush=True)
    for line in info["ptxas"].splitlines():
        if "ptxas info" in line and ("registers" in line or "spill" in line
                                     or "Compiling" in line):
            print(f"  {line.strip()}")

    t = time.perf_counter()
    worst = kernel_sweep(dev, fmt, bu, ref)
    print(f"kernel sweep: bits {list(SWEEP_BITS)} x n {list(SWEEP_N)} "
          f"bit-exact vs plain on card and numpy codec "
          f"({time.perf_counter() - t:.1f}s)", flush=True)

    ds_rows = 1 << args.rows_log2
    obj_rows = len(core.plan_partition(core.LogicalDataset(
        "events", (core.Column("e_pt", "float32"),
                   core.Column("run", "int32"), core.Column("hits", "int32")),
        ds_rows, 4096), core.PartitionPolicy()).extents[0])
    obj_bits = 7                                   # run in [0, 100)
    rng = np.random.default_rng(2)
    obj_words = _words_tensor(fmt.bitpack_encode(
        _values(rng, obj_bits, obj_rows), obj_bits), obj_bits).to(dev)
    at_obj = kernel_timing(bu, obj_rows, obj_bits, obj_words, 200)
    big_n, big_bits = 1 << 28, 17
    big_words = torch.randint(-(1 << 31), 1 << 31, (big_n // 32, big_bits),
                              dtype=torch.int32, device=dev)
    big_out = bu.bitunpack_groups(big_words, big_bits, big_n)
    torch.cuda.synchronize()
    if not torch.equal(big_out, bu.bitunpack_plain(big_words, big_bits,
                                                   big_n)):
        raise AssertionError("bitunpack differs at 2^28 values")
    del big_out
    at_big = kernel_timing(bu, big_n, big_bits, big_words, 20)
    del big_words
    for name, r in (("main-path object column", at_obj),
                    ("2^28 values", at_big)):
        print(f"kernel time [{name}] n={r['n']} bitpack{r['bits']}: "
              f"device {r['ms']:.5f} ms ({r['GB_per_s']:.0f} GB/s), bound "
              f"{r['bound_ms']:.5f} ms at 3.35 TB/s "
              f"({r['bound_ms'] / r['ms']:.1%} of it), plain device "
              f"{r['plain_ms']:.5f} ms; per call with launch: kernel "
              f"{r['call_ms']:.5f} ms, plain {r['plain_call_ms']:.5f} ms"
              f"  [{card}]", flush=True)
    split = object_breakdown(dev, fmt, bu, obj_rows, obj_bits)
    print(f"one object column n={obj_rows} bitpack{obj_bits}: H2D "
          f"{split['h2d_ms']:.4f} ms, kernel {split['kernel_ms']:.4f} ms, "
          f"D2H {split['d2h_ms']:.4f} ms  [{card}]", flush=True)

    res = main_path(dev, core, fmt, bu, args.rows_log2, args.seed)
    if args.rows_log2 < FULL_ROWS_LOG2:
        print(f"reduced: main path at 2^{args.rows_log2} rows of the "
              f"paper's 2^{FULL_ROWS_LOG2}")
    print("main path: " + json.dumps(res), flush=True)
    print("kernels: bitunpack (held against its plain version)")
    print(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "bitunpack", "route": "cuda",
        "source": "src/repro_torch/csrc/bitunpack.cu",
        "replaces": "src/repro/kernels/bitunpack.py:52",
        "launches": res["launches"], "max_abs_err": worst,
        "ms": at_obj["ms"], "plain_ms": at_obj["plain_ms"],
        "bound_ms": at_obj["bound_ms"], "bound_by": "bytes",
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
