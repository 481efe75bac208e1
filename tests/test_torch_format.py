"""The port's block format against the reference's: byte-identical blobs,
cross-package decode, equal zone maps, digests and codec choices."""

import numpy as np
import pytest

from repro.core import format as ref_fmt
from repro_torch.core import format as pt_fmt


@pytest.fixture(autouse=True)
def cpu_decode():
    """Reference pinned to its bit-exact numpy codec, port to its plain
    PyTorch decode on the CPU; both restored afterwards."""
    pt_mode = pt_fmt.get_bitunpack_backend()
    ref_fmt.set_bitunpack_backend("numpy")
    pt_fmt.set_bitunpack_backend("plain")
    yield
    ref_fmt.set_bitunpack_backend("auto")
    pt_fmt.set_bitunpack_backend(pt_mode)


def _table(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "f": rng.normal(size=n).astype(np.float32),
        "d": rng.gamma(2.0, 20.0, n),
        "run": rng.integers(0, 100, n).astype(np.int32),
        "hits": rng.poisson(12, n).astype(np.int32),
        "neg": rng.integers(-50, 50, n).astype(np.int64),
        "tok": rng.integers(0, 1 << 11, (n, 64)).astype(np.int32),
    }


CASES = [
    ("col", "none"),
    ("col", "zlib"),
    ("col", "auto"),
    ("col", "bitpack"),
    ("row", "none"),
]


def _codecs(table, kind):
    if kind == "none":
        return {}
    if kind == "zlib":
        return {k: "zlib" for k in table}
    if kind == "auto":
        return ref_fmt.auto_codecs(table)
    # an explicit width per int column, wider than needed for one
    return {"run": "bitpack7", "hits": "bitpack13", "tok": "bitpack24"}


@pytest.mark.parametrize("layout,kind", CASES)
@pytest.mark.parametrize("n", [0, 1, 33, 1000])
def test_encode_block_byte_identical(layout, kind, n):
    table = _table(n, n + 1)
    codecs = _codecs(table, kind)
    ref_blob = ref_fmt.encode_block(table, layout=layout, codecs=codecs)
    pt_blob = pt_fmt.encode_block(table, layout=layout, codecs=codecs)
    assert pt_blob == ref_blob
    assert pt_fmt.content_digest(pt_blob) == ref_fmt.content_digest(ref_blob)
    assert pt_fmt.block_header(pt_blob) == ref_fmt.block_header(ref_blob)
    # each package decodes the other's blob, whole and projected
    for cols in (None, ["run", "d"]):
        a = ref_fmt.decode_block(pt_blob, columns=cols)
        b = pt_fmt.decode_block(ref_blob, columns=cols)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k])
            assert np.array_equal(b[k], table[k])


def test_codec_choice_and_metadata_equal():
    table = _table(777, 5)
    assert pt_fmt.auto_codecs(table) == ref_fmt.auto_codecs(table)
    assert (pt_fmt.auto_codecs(table, bitpack_ints=False)
            == ref_fmt.auto_codecs(table, bitpack_ints=False))
    assert pt_fmt.zone_map(table) == ref_fmt.zone_map(table)
    strs = {"s": np.array(["b", "a", "c"]), "bs": np.array([b"z", b"y"])}
    assert pt_fmt.zone_map(strs) == ref_fmt.zone_map(strs)
    blob = ref_fmt.encode_block(table, codecs=ref_fmt.auto_codecs(table))

    def fields(cols):  # the two packages' Column classes differ
        return [(c.name, c.dtype, c.shape) for c in cols]

    assert fields(pt_fmt.schema_columns(blob)) == fields(
        ref_fmt.schema_columns(blob))
    for v in (b"", b"abc", blob):
        assert pt_fmt.content_digest(v) == ref_fmt.content_digest(v)


@pytest.mark.parametrize("bits", [1, 7, 17, 24, 32])
def test_bitpack_codec_functions_equal(bits):
    rng = np.random.default_rng(bits)
    v = rng.integers(0, 1 << bits, 1234, dtype=np.uint64).astype(np.uint32)
    w = pt_fmt.bitpack_encode(v, bits)
    assert np.array_equal(w, ref_fmt.bitpack_encode(v, bits))
    assert np.array_equal(pt_fmt.bitpack_decode(w, bits, v.size), v)
    assert pt_fmt.bitpack_width(int(v.max())) == ref_fmt.bitpack_width(
        int(v.max()))


def test_transform_layout_identical():
    table = {k: v for k, v in _table(300, 9).items() if k != "tok"}
    blob = ref_fmt.encode_block(table)
    assert (pt_fmt.transform_layout(blob, "row")
            == ref_fmt.transform_layout(blob, "row"))


@pytest.mark.parametrize("mode", ["plain", "numpy"])
def test_port_backends_decode_bit_exact(mode):
    table = _table(500, 3)
    blob = ref_fmt.encode_block(table, codecs=ref_fmt.auto_codecs(table))
    pt_fmt.set_bitunpack_backend(mode)
    got = pt_fmt.decode_block(blob)
    for k, v in table.items():
        assert np.array_equal(got[k], v)


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        pt_fmt.set_bitunpack_backend("auto")
