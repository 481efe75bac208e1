"""Physical block format + codecs ("physical design management", paper §5).

Objects hold *blocks*: a self-describing serialization of a column table
(standing in for the paper's Flatbuffers/Arrow wrappers).  A block has:

  header (json): schema, n_rows, layout ("row"|"col"), per-column codec,
                 per-column zone map (min/max) for object pruning — the
                 paper's RocksDB-index analogue, kept *inside* the object
                 plus mirrored into OSD xattrs.
  body: per-column encoded buffers (col layout) or one interleaved buffer
        (row layout).

Codecs:
  none          — raw little-endian buffer
  zlib          — DEFLATE (cheap stand-in for generic compression)
  bitpack<b>    — planar bitpack for unsigned ints < 2**b: each group of
                  32 values becomes b uint32 words, word k holding bit k
                  of all 32 values.  Decode is a 32x32 bit transpose
                  per group (kernels/bitunpack runs it on the card), so
                  the *storage side* decompression runs on the device —
                  the paper's `compress` offload.

Layout transformation (row<->col) is lossless and is the mechanism behind
``LocalVOL``'s physical-design optimization.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Mapping

import numpy as np

from repro_torch.core.logical import Column
from repro_torch.kernels.bitunpack import bitunpack_words

_MAGIC = b"SKYB"
_VERSION = 2

# crc32c when the (optional) C extension is around, zlib's crc32
# otherwise — both run at C speed over the encoded blob; the store only
# needs A content digest that is cheap enough to verify on every read,
# not a specific polynomial
try:  # pragma: no cover - environment-dependent
    from crc32c import crc32c as _crc
except Exception:  # pragma: no cover
    _crc = zlib.crc32


def content_digest(blob: bytes) -> int:
    """Content digest of an encoded object blob (crc32c when available,
    crc32 otherwise).  Stamped into every object's xattrs at write time
    (``ObjectStore.put`` / ``put_batch`` / each replication hop) so any
    copy is independently verifiable: reads, ``scrub()`` and
    digest-verified ``recover()`` all check stored bytes against this
    value before serving or propagating them."""
    return _crc(bytes(blob)) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# planar bitpack codec (numpy; kernels/bitunpack has the CUDA decode)
# --------------------------------------------------------------------------


def bitpack_width(max_value: int) -> int:
    """Bits needed for values in [0, max_value]."""
    return max(1, int(max_value).bit_length())


def auto_codecs(table: Mapping[str, np.ndarray], *,
                bitpack_ints: bool = True) -> dict[str, str]:
    """Default per-column codec choice for a col-layout block: bitpack
    non-negative integer columns whose width pays off (<= 24 bits; wider
    loses to raw int32).  Shared by ``LocalVOL.encode`` and the OSD-side
    ``compact_merge`` op so a compacted object round-trips through the
    same codec policy as a freshly written one."""
    out: dict[str, str] = {}
    if not bitpack_ints:
        return out
    for k, a in table.items():
        a = np.asarray(a)
        if (np.issubdtype(a.dtype, np.integer)
                and a.size and int(a.min()) >= 0):
            bits = bitpack_width(int(a.max()))
            if bits <= 24:
                out[k] = f"bitpack{bits}"
    return out


# (swap distance, mask) pairs for the 5 butterfly stages of a 32x32
# bit-matrix transpose (Hacker's Delight §7-3): stage j exchanges the
# masked j-bit sub-blocks between rows k and k+j.
_BUTTERFLY = ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
              (2, 0x33333333), (1, 0x55555555))


def _bit_transpose32(a: np.ndarray) -> np.ndarray:
    """Vectorized 32x32 bit-matrix transpose over the leading axis.

    ``a`` is (G, 32) uint32; returns (G, 32) uint32 with
    ``out[:, i] bit j == a[:, j] bit i``.  Five masked shift-swap
    stages over the whole array — no per-bit Python loop, and the
    working set is just the (G, 32) matrix itself.
    """
    if not a.size:
        return a.copy()
    at = a.T.copy()                              # (32, G): G contiguous;
    # always a private buffer — the butterfly XORs in place and must
    # never scribble on the caller's array (a.T can alias it when G==1)
    for j, m in _BUTTERFLY:
        m = np.uint32(m)
        # rows with (k & j) == 0 are the first j of every 2j-row block,
        # so each stage is a pure reshape — contiguous views, no gathers
        g = at.reshape(-1, 2, j, at.shape[-1])   # (pairs, lo|hi, j, G)
        lo, hi = g[:, 0], g[:, 1]
        # swap the high-bit block of the lo rows with the low-bit block
        # of the hi rows: [[A,B],[C,D]] -> [[A,C],[B,D]] at every scale
        t = ((lo >> np.uint32(j)) ^ hi) & m
        hi ^= t
        lo ^= t << np.uint32(j)
    return at.T


def bitpack_encode(values: np.ndarray, bits: int) -> np.ndarray:
    """(n,) uint32-able -> (ceil(n/32), bits) uint32, planar layout.

    Each 32-value group is one 32x32 bit matrix; the planar encoding is
    exactly its transpose, done via :func:`_bit_transpose32` (word
    planes >= ``bits`` are all-zero and dropped).  Bit-exact with the
    historical per-bit-loop implementation, minus the Python loop.
    """
    v = np.ascontiguousarray(values, dtype=np.uint32).ravel()
    if v.size and int(v.max()) >= (1 << bits):
        raise ValueError(f"value {int(v.max())} needs more than {bits} bits")
    n = v.size
    n_groups = -(-n // 32) if n else 0
    padded = np.zeros((n_groups * 32,), np.uint32)
    padded[:n] = v
    g = padded.reshape(n_groups, 32)                       # (G, 32)
    return np.ascontiguousarray(_bit_transpose32(g)[:, :bits])


def bitpack_decode(words: np.ndarray, bits: int, n: int) -> np.ndarray:
    """(G, bits) uint32 -> (n,) uint32.

    Inverse planar transform = the same 32x32 bit transpose with the
    missing (all-zero) word planes restored.  No per-bit Python loop.
    """
    w = np.ascontiguousarray(words, dtype=np.uint32).reshape(-1, bits)
    full = np.zeros((w.shape[0], 32), np.uint32)
    full[:, :bits] = w
    return _bit_transpose32(full).ravel()[:n]


# --------------------------------------------------------------------------
# bitpack decode backend selection
# --------------------------------------------------------------------------

# "device" (the default): the CUDA kernel (kernels/bitunpack) decodes
# every bitpack column on cuda:0, so the storage-side decode runs on the
# card; with no card, or a kernel that does not build, the decode raises.
# "plain": the kernel's plain PyTorch version on the CPU.  "numpy": the
# butterfly codec above.  No mode falls back to another.
_BITUNPACK_MODES = ("device", "plain", "numpy")
_BITUNPACK_MODE = "device"


def set_bitunpack_backend(mode: str) -> None:
    """Select the bitpack-column decode backend: "device" | "plain" |
    "numpy" (see module comment).  Takes effect on the next decode."""
    global _BITUNPACK_MODE
    if mode not in _BITUNPACK_MODES:
        raise ValueError(f"unknown bitunpack backend {mode!r}")
    _BITUNPACK_MODE = mode


def get_bitunpack_backend() -> str:
    return _BITUNPACK_MODE


def _bitunpack_dispatch(words, bits: int, n: int) -> np.ndarray:
    """Decode through the selected backend; errors propagate."""
    mode = _BITUNPACK_MODE
    if mode == "numpy":
        return bitpack_decode(words, bits, n)
    return bitunpack_words(words, bits, n,
                           device="cuda:0" if mode == "device" else "cpu")


# --------------------------------------------------------------------------
# per-column encode/decode
# --------------------------------------------------------------------------


def _encode_column(a: np.ndarray, codec: str) -> bytes:
    raw = np.ascontiguousarray(a)
    if codec == "none":
        return raw.tobytes()
    if codec == "zlib":
        return zlib.compress(raw.tobytes(), level=1)
    if codec.startswith("bitpack"):
        bits = int(codec[len("bitpack"):])
        if not np.issubdtype(raw.dtype, np.integer):
            raise TypeError(f"bitpack needs ints, got {raw.dtype}")
        return bitpack_encode(raw.ravel(), bits).tobytes()
    raise ValueError(f"unknown codec {codec!r}")


def _decode_column(buf, codec: str, dtype: str,
                   shape: tuple[int, ...]) -> np.ndarray:
    """Decode one column buffer (bytes or memoryview).

    Codec ``none`` is zero-copy: the returned (read-only) array aliases
    the block's buffer instead of materializing a private copy — the
    scan hot path never duplicates raw column bytes.
    """
    n = int(np.prod(shape, dtype=np.int64)) if shape else 0
    if codec == "none":
        return np.frombuffer(buf, dtype=dtype).reshape(shape)
    if codec == "zlib":
        # decompress already yields a fresh buffer; alias it, no copy
        return np.frombuffer(zlib.decompress(buf), dtype=dtype).reshape(
            shape)
    if codec.startswith("bitpack"):
        bits = int(codec[len("bitpack"):])
        words = np.frombuffer(buf, dtype=np.uint32)
        return _bitunpack_dispatch(words, bits, n).astype(dtype).reshape(
            shape)
    raise ValueError(f"unknown codec {codec!r}")


# --------------------------------------------------------------------------
# block encode/decode
# --------------------------------------------------------------------------


def zone_map(table: Mapping[str, np.ndarray]) -> dict:
    """Per-column min/max (object-pruning index).  Numeric columns map
    to float bounds; string columns to lexicographic bounds, which make
    equality/range/prefix predicates (``expr.StrPrefix``) prunable the
    same interval-arithmetic way."""
    zm = {}
    for k, a in table.items():
        a = np.asarray(a)
        if not a.size:
            continue
        if np.issubdtype(a.dtype, np.number):
            zm[k] = [float(a.min()), float(a.max())]
        elif a.dtype.kind in ("U", "S"):
            # str dtypes have no min/max ufunc loop; sort is C-speed
            srt = np.sort(a.ravel())
            lo, hi = srt[0], srt[-1]
            if a.dtype.kind == "S":
                lo, hi = (lo.decode("utf-8", "replace"),
                          hi.decode("utf-8", "replace"))
            zm[k] = [str(lo), str(hi)]
    return zm


def encode_block(
    table: Mapping[str, np.ndarray],
    *,
    layout: str = "col",
    codecs: Mapping[str, str] | None = None,
) -> bytes:
    """Serialize a column table into a block."""
    if layout not in ("row", "col"):
        raise ValueError(layout)
    codecs = dict(codecs or {})
    cols = []
    n_rows = None
    for name, a in table.items():
        a = np.asarray(a)
        if n_rows is None:
            n_rows = a.shape[0] if a.ndim else 0
        elif a.shape[0] != n_rows:
            raise ValueError(f"ragged block: {name}")
        cols.append({"name": name, "dtype": str(a.dtype),
                     "shape": list(a.shape),
                     "codec": codecs.get(name, "none")})

    bufs: list[bytes] = []
    if layout == "col":
        for c in cols:
            bufs.append(_encode_column(np.asarray(table[c["name"]]),
                                       c["codec"]))
    else:  # row layout: interleave via a structured scratch array
        if any(c["codec"] != "none" for c in cols):
            raise ValueError("row layout supports codec 'none' only")
        fields = [(c["name"], c["dtype"],
                   tuple(c["shape"][1:]) or ()) for c in cols]
        rec = np.zeros(n_rows or 0, dtype=np.dtype(fields))
        for c in cols:
            rec[c["name"]] = table[c["name"]]
        bufs.append(rec.tobytes())

    header = {"v": _VERSION, "layout": layout, "n_rows": int(n_rows or 0),
              "columns": cols, "zone_map": zone_map(table),
              "lens": [len(b) for b in bufs]}
    hjson = json.dumps(header).encode()
    return b"".join([_MAGIC, struct.pack("<I", len(hjson)), hjson, *bufs])


def block_header(blob: bytes) -> dict:
    if blob[:4] != _MAGIC:
        raise ValueError("not a block")
    (hlen,) = struct.unpack("<I", blob[4:8])
    return json.loads(blob[8:8 + hlen])


def decode_block(blob: bytes,
                 columns: list[str] | None = None) -> dict[str, np.ndarray]:
    """Deserialize (optionally projecting a column subset without touching
    other columns' bytes — col layout only reads what it needs)."""
    header = block_header(blob)
    (hlen,) = struct.unpack("<I", blob[4:8])
    off = 8 + hlen
    out: dict[str, np.ndarray] = {}
    if header["layout"] == "col":
        view = memoryview(blob)  # zero-copy column slicing
        for c, blen in zip(header["columns"], header["lens"]):
            if columns is None or c["name"] in columns:
                out[c["name"]] = _decode_column(
                    view[off:off + blen], c["codec"], c["dtype"],
                    tuple(c["shape"]))
            off += blen
    else:
        fields = [(c["name"], c["dtype"],
                   tuple(c["shape"][1:]) or ()) for c in header["columns"]]
        rec = np.frombuffer(blob[off:off + header["lens"][0]],
                            dtype=np.dtype(fields))
        for c in header["columns"]:
            if columns is None or c["name"] in columns:
                out[c["name"]] = np.ascontiguousarray(rec[c["name"]])
    if columns is not None:
        missing = set(columns) - set(out)
        if missing:
            raise KeyError(f"columns not in block: {sorted(missing)}")
    return out


def transform_layout(blob: bytes, to: str,
                     codecs: Mapping[str, str] | None = None) -> bytes:
    """Row<->col physical transformation (paper §5 'physical design')."""
    table = decode_block(blob)
    return encode_block(table, layout=to, codecs=codecs)


def schema_columns(blob: bytes) -> list[Column]:
    return [Column(c["name"], c["dtype"], tuple(c["shape"][1:]))
            for c in block_header(blob)["columns"]]
