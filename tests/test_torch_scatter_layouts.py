"""Port parity of the sorted scatter-adds B2 (``scatter_add_sorted_rows``)
and B4 (``tiled_scatter_add_sorted_rows``) on id layouts that cross the
CUDA kernels' tile edges (``chip_smoke.scatter_layouts``: a warp owns 32
id slots and reads 64), with int32 and int64 ids.

On the CPU the wrappers run their plain versions; each is held BITWISE
against the JAX package's Pallas kernel in interpret mode, which takes
the int32 copy of the same numpy ids. The inputs hold -0.0 in some table
rows and deltas, so B2's ``delta + 0`` where a run starts inside a group
of 8 shows in the bits. Out-of-range ids have no JAX reference (the TPU
kernels take in-range ids only): they are held to the plain versions'
drop. The CUDA kernels are held against the plain versions on the card
by the card-only test below and by ``chip_smoke.py``.
"""

import zlib

import numpy as np
import pytest

import jax.numpy as jnp

import _torch_port
import chip_smoke
from multiverso_tpu.ops.pallas_rows import (
    scatter_add_sorted_rows as jax_b2,
    tiled_scatter_add_sorted_rows as jax_b4)

torch = rows = None  # set by _load_port

LAYOUTS = chip_smoke.scatter_layouts()
ROWS, COLS = 64, 24
KERNELS = ("scatter_add_sorted_rows", "tiled_scatter_add_sorted_rows")
_JAX = {"scatter_add_sorted_rows": jax_b2,
        "tiled_scatter_add_sorted_rows": jax_b4}
_want = {}   # (kernel, layout, sign) -> the JAX kernel's table


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, rows
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.ops import rows


@pytest.fixture
def card():
    """A CUDA device, or skip: B2 and B4 are CUDA kernels with no CPU
    mode (run on the card by chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B2 and B4 are CUDA kernels with no "
                    "CPU mode (run on the card by chip_smoke.py)")
    return torch.device("cuda", 0)


def _inputs(name, n):
    """A table and deltas of many magnitudes, -0.0 in some rows of each."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    table = rng.normal(size=(ROWS, COLS)).astype(np.float32)
    table[rng.random(ROWS) < 0.2] = -0.0
    deltas = (rng.normal(size=(n, COLS)) *
              10.0 ** rng.integers(-3, 4, size=(n, 1))).astype(np.float32)
    deltas[rng.random(n) < 0.2] = -0.0
    return table, deltas


def _jax_table(kernel, layout, sign):
    key = (kernel, layout, sign)
    if key not in _want:
        ids = LAYOUTS[layout]
        table, deltas = _inputs(layout, len(ids))
        _want[key] = np.asarray(_JAX[kernel](
            jnp.asarray(table), jnp.asarray(ids.astype(np.int32)),
            jnp.asarray(deltas), interpret=True, sign=sign))
    return _want[key]


@pytest.mark.parametrize("id_type", ["int32", "int64"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kernel", KERNELS)
def test_layout_bitwise_vs_jax(kernel, layout, sign, id_type):
    ids = LAYOUTS[layout].astype(id_type)
    table, deltas = _inputs(layout, len(ids))
    got = torch.as_tensor(table.copy())
    out = getattr(rows, kernel)(got, torch.as_tensor(ids),
                                torch.as_tensor(deltas), sign=sign)
    assert out is got                                     # in place
    assert np.array_equal(got.numpy().view(np.int32),
                          _jax_table(kernel, layout, sign).view(np.int32))
    expected = table.astype(np.float64)
    np.add.at(expected, ids, sign * deltas.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-4, atol=1e-3)
    assert rows.LAUNCHES[kernel] == 0                     # CPU: plain version


@pytest.mark.parametrize("id_type", ["int32", "int64"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("kernel", KERNELS)
def test_out_of_range_ids_are_dropped(kernel, sign, id_type):
    ids = chip_smoke.out_of_range_ids(ROWS).astype(id_type)
    table, deltas = _inputs("out_of_range", len(ids))
    got = torch.as_tensor(table.copy())
    getattr(rows, kernel)(got, torch.as_tensor(ids), torch.as_tensor(deltas),
                          sign=sign)
    keep = (ids >= 0) & (ids < ROWS)
    expected = table.astype(np.float64)
    np.add.at(expected, ids[keep], sign * deltas[keep].astype(np.float64))
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-4, atol=1e-3)
    untouched = np.setdiff1d(np.arange(ROWS), ids[keep])
    assert np.array_equal(got.numpy()[untouched].view(np.int32),
                          table[untouched].view(np.int32))
    if kernel == "tiled_scatter_add_sorted_rows":
        # B4's rounding does not depend on the dropped lanes: bitwise to
        # the in-range lanes alone.
        alone = torch.as_tensor(table.copy())
        rows.tiled_scatter_add_sorted_rows(
            alone, torch.as_tensor(ids[keep]),
            torch.as_tensor(deltas[keep]), sign=sign)
        assert torch.equal(got, alone)


class _FakeLib:
    """Stands in for the CUDA library: records each call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("kernel", KERNELS)
def test_launch_reads_ids_in_place(kernel, monkeypatch):
    """The card path's host side: int32 and int64 ids reach their entry
    point by their own pointer (no cast launch), other integer types are
    cast to int32, strided ids and float64 deltas are made contiguous
    float32, each launch is counted once, and no ids launch nothing."""
    fake = _FakeLib()
    monkeypatch.setattr(rows, "_lib", lambda: fake)
    monkeypatch.setattr(rows._build, "stream", lambda t: 7)
    monkeypatch.setitem(rows.LAUNCHES, kernel, 0)
    table = torch.zeros(10, 4)
    deltas = torch.ones(3, 4)
    entry = {"scatter_add_sorted_rows": "mv_scatter_add_sorted_rows",
             "tiled_scatter_add_sorted_rows":
             "mv_tiled_scatter_add_sorted_rows"}[kernel]
    for dtype, suffix in ((torch.int32, ""), (torch.int64, "_i64")):
        ids = torch.tensor([1, 2, 2], dtype=dtype)
        rows._launch_sorted(kernel, table, ids, deltas, -1.0)
        name, args = fake.calls[-1]
        assert name == entry + suffix
        assert args == (table.data_ptr(), ids.data_ptr(), deltas.data_ptr(),
                        3, 10, 4, -1.0, 7)
    ids = torch.tensor([1, 2, 2], dtype=torch.int16)
    rows._launch_sorted(kernel, table, ids, deltas.double(), 1.0)
    name, args = fake.calls[-1]
    assert name == entry and args[1] != ids.data_ptr()
    assert args[2] != deltas.data_ptr()
    strided = torch.tensor([1, 0, 2, 0, 2, 0])[::2]
    rows._launch_sorted(kernel, table, strided, deltas, 1.0)
    name, args = fake.calls[-1]
    assert name == entry + "_i64" and args[1] != strided.data_ptr()
    assert rows.LAUNCHES[kernel] == 4
    for bad_ids, bad_deltas in ((torch.zeros(3, 1, dtype=torch.int64),
                                 deltas),
                                (torch.zeros(3, dtype=torch.int64),
                                 torch.ones(3, 5))):
        with pytest.raises(ValueError):
            rows._launch_sorted(kernel, table, bad_ids, bad_deltas, 1.0)
    rows._launch_sorted(kernel, table, torch.zeros(0, dtype=torch.int64),
                        torch.zeros(0, 4), 1.0)              # no ids
    assert len(fake.calls) == 4 and rows.LAUNCHES[kernel] == 4


def test_tensors_on_other_devices_are_refused():
    table = torch.zeros(4, 4)
    meta = torch.empty(2, dtype=torch.int64, device="meta")
    for kernel in KERNELS:
        with pytest.raises(ValueError):
            getattr(rows, kernel)(table, meta, torch.zeros(2, 4))


def test_kernels_match_plain_on_card(card):
    """Every layout, at row widths that take each vector width and lane
    group, int32 and int64 ids, both signs: the kernels bitwise to their
    plain versions on the card."""
    for layout, ids_np in sorted(LAYOUTS.items()):
        for cols in (1, 3, 25, 50, 64, 128, 129):
            rng = np.random.default_rng(cols)
            table = torch.as_tensor(rng.normal(size=(ROWS, cols)),
                                    dtype=torch.float32, device=card)
            deltas = torch.as_tensor(rng.normal(size=(len(ids_np), cols)),
                                     dtype=torch.float32, device=card)
            for id_type in (torch.int32, torch.int64):
                ids = torch.as_tensor(ids_np, dtype=id_type, device=card)
                for kernel in KERNELS:
                    for sign in (1.0, -1.0):
                        a, b = table.clone(), table.clone()
                        getattr(rows, kernel)(a, ids, deltas, sign)
                        getattr(rows, kernel + "_plain")(b, ids, deltas,
                                                         sign)
                        assert torch.equal(a, b), (layout, cols, id_type,
                                                   kernel, sign)
