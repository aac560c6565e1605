"""Port parity: the wire filters (``utils/quantization.py``) and the PS
payload codec (``parallel/ps_service.py::pack_payload``/``unpack_payload``)
bitwise against the JAX package's on the same seeded inputs.

Mirrors ``tests/test_quantization.py`` (its filter and codec cases; the
DC-ASGD updater cases are mirrored in ``test_torch_updaters.py``).
"""

import numpy as np
import pytest

import _torch_port
from multiverso_tpu.parallel import ps_service as jps
from multiverso_tpu.utils import quantization as jq

tq = tps = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global tq, tps
    _torch_port.load_torch()
    from multiverso_tpu_torch.parallel import ps_service as tps
    from multiverso_tpu_torch.utils import quantization as tq


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=257).astype(np.float32)
    sparse = np.where(rng.random(300) < 0.1, rng.normal(size=300),
                      rng.normal(size=300) * 1e-3).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40,
                        -3.4e38, 65504.0, 1.0 + 2 ** -8, 1.0 + 2 ** -9],
                       dtype=np.float32)
    return {"dense": dense, "sparse": sparse, "special": special,
            "matrix": rng.normal(size=(7, 5)).astype(np.float32),
            "empty": np.zeros((0, 4), np.float32)}


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("clip", [0.0, 0.01, 0.5])
@pytest.mark.parametrize("name", ["dense", "sparse", "special", "matrix",
                                  "empty"])
def test_sparse_filter_bitwise(clip, name):
    v = _inputs()[name]
    j = jq.SparseFilter(clip=clip).filter_in(v)
    t = tq.SparseFilter(clip=clip).filter_in(v)
    assert j[0] == t[0]
    _same(j[1], t[1])
    _same(j[2], t[2])
    _same(jq.SparseFilter(clip).filter_out(*j, v.size),
          tq.SparseFilter(clip).filter_out(*t, v.size))


@pytest.mark.parametrize("name", ["dense", "special", "matrix", "empty"])
def test_bf16_bits_bitwise(name):
    v = _inputs()[name]
    _same(jq.f32_to_bf16_bits(v), tq.f32_to_bf16_bits(v))
    bits = jq.f32_to_bf16_bits(v)
    _same(jq.bf16_bits_to_f32(bits), tq.bf16_bits_to_f32(bits))


@pytest.mark.parametrize("size", [13, 64, 257])
def test_one_bit_error_feedback_bitwise(size):
    """Twenty encodes through each package's filter carry the same error
    feedback state and produce the same bits and scales."""
    rng = np.random.default_rng(size)
    fj, ft = jq.OneBitsFilter(size), tq.OneBitsFilter(size)
    for _ in range(20):
        v = rng.normal(size=size).astype(np.float32)
        bj, psj, nsj = fj.encode(v)
        bt, pst, nst = ft.encode(v)
        _same(bj, bt)
        assert np.float32(psj).tobytes() == np.float32(pst).tobytes()
        assert np.float32(nsj).tobytes() == np.float32(nst).tobytes()
        _same(jq.OneBitsFilter.decode(bj, psj, nsj, size),
              tq.OneBitsFilter.decode(bt, pst, nst, size))


# The one-bit filter packs non-empty 1-D deltas only.
_PACK_CASES = [(m, n) for m in ("none", "sparse", "bf16")
               for n in ("dense", "sparse", "special", "matrix", "empty")]
_PACK_CASES += [("onebit", n) for n in ("dense", "sparse", "special")]


@pytest.mark.parametrize("mode,name", _PACK_CASES)
def test_pack_payload_bitwise(mode, name):
    v = _inputs()[name]
    jf = jq.OneBitsFilter(v.size) if mode == "onebit" else None
    tf = tq.OneBitsFilter(v.size) if mode == "onebit" else None
    jb = jps.pack_payload(v, mode, jf)
    tb = tps.pack_payload(v, mode, tf)
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        _same(a, b)
    _same(jps.unpack_payload(jb), tps.unpack_payload(tb))


def test_sparse_filter_zero_length_round_trip():
    for clip in (0.0, 0.5):
        f = tq.SparseFilter(clip=clip)
        for empty in (np.zeros(0, np.float32), np.zeros((0, 4), np.float32),
                      np.zeros((3, 0), np.float32)):
            compressed, payload, idx = f.filter_in(empty)
            assert not compressed and idx is None
            out = f.filter_out(compressed, payload, idx, 0)
            assert out.shape == (0,) and out.dtype == np.float32
    f = tq.SparseFilter(clip=0.5)
    compressed, payload, idx = f.filter_in(np.zeros(6, np.float32))
    assert compressed and len(payload) == 0
    np.testing.assert_array_equal(
        f.filter_out(True, payload, idx, 6), np.zeros(6, np.float32))


def test_one_bit_partial_byte():
    f = tq.OneBitsFilter(size=13)
    v = np.linspace(-1, 1, 13).astype(np.float32)
    bits, ps, ns = f.encode(v)
    out = tq.OneBitsFilter.decode(bits, ps, ns, 13)
    assert out.shape == (13,)
    assert set(np.unique(out)).issubset({np.float32(ps), np.float32(ns)})
