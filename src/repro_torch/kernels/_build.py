"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain ``extern "C"``
launcher; headers shared between kernels are ``csrc/*.cuh``.  On first
use a kernel is compiled by ``nvcc`` for ``sm_90a`` into a shared
library under the package's ``build/`` directory and loaded with
``ctypes``.  The library's file name carries a digest of the source, the
shared headers and the flags, so an edited source is rebuilt and a
stale library is never loaded.  :func:`build_all` starts one ``nvcc``
per kernel at once.  Nothing is compiled at import time: this module
imports on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall (0.0 when a built library was reused),
#          "ptxas": nvcc's register/spill report, "path": library}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                       "first use and need the CUDA toolkit")


def _compile(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        build_info[name] = {"seconds": 0.0, "path": str(lib),
                            "ptxas": log.read_text() if log.exists() else ""}
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: processes that build the
    # same source at once each finish with a whole library in place
    tmp = lib.with_name(
        f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {src.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    report = proc.stdout + proc.stderr
    log.write_text(report)
    os.replace(tmp, lib)
    build_info[name] = {"seconds": seconds, "path": str(lib),
                        "ptxas": report}
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first call.

    Thread-safe: scans decode on the store's pool threads, so several
    can reach a kernel's first launch together; one builds, the others
    wait for it."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_compile(name)))
        return _libs[name]


def build_all(names) -> None:
    """Build and load the named kernels, one ``nvcc`` each, all started
    together (the build is the slow part of a cold start)."""
    names = [n for n in names if n not in _libs]
    if not names:
        return
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(_compile, names))
    with _lock:
        for name, lib in zip(names, built):
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(lib))
