"""Port parity: the row kernels' plain versions (B1 gather, B2 sorted
scatter-add) against the JAX package's Pallas kernels in interpret mode.

Both sides get the same numpy inputs. Tolerance: BITWISE for both — the
gather copies rows, and the port's plain scatter-add folds each aligned
group of 8 lanes in the TPU kernel's order (``acc = delta + acc``) and
adds each group's partial to its row group after group, exactly as the
interpret-mode kernel does. The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``.
"""

import zlib

import numpy as np
import pytest

import jax.numpy as jnp

import _torch_port
from multiverso_tpu.ops.pallas_rows import (gather_rows as jax_gather_rows,
                                            scatter_add_rows as jax_scatter,
                                            scatter_add_sorted_rows as
                                            jax_scatter_sorted)

torch = rows = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, rows
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.ops import rows


def _t(a):
    return torch.as_tensor(np.array(a, copy=True))


def test_gather_rows_bitwise():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(64, 32)).astype(np.float32)
    ids = np.array([3, 0, 63, 3, 17, 17, 5, 40, 9], dtype=np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(ids),
                                      interpret=True))
    got = rows.gather_rows(_t(table), _t(ids)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, table[ids])
    assert rows.LAUNCHES["gather_rows"] == 0      # CPU: plain version


def _scatter_case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "unique":
        ids = np.array([1, 4, 9], np.int32)
    elif name == "duplicates":
        ids = np.array([2, 2, 2, 5], np.int32)
    elif name == "cross_group_16":
        ids = np.full(16, 1, np.int32)
    elif name == "cross_group_10_6":
        ids = np.array([1] * 10 + [3] * 6, np.int32)
    elif name == "long_runs_padded":
        ids = np.sort(rng.integers(0, 32, size=67)).astype(np.int32)
    else:   # a run that starts mid-group and ends in the padded tail
        ids = np.array([0, 1, 2] + [7] * 12, np.int32)
    table = rng.normal(size=(32, 24)).astype(np.float32)
    deltas = rng.normal(size=(len(ids), 24)).astype(np.float32)
    return table, ids, deltas


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("case", ["unique", "duplicates", "cross_group_16",
                                  "cross_group_10_6", "long_runs_padded",
                                  "mid_group_run"])
def test_scatter_add_sorted_bitwise(case, sign):
    table, ids, deltas = _scatter_case(case)
    want = np.asarray(jax_scatter_sorted(jnp.asarray(table), jnp.asarray(ids),
                                         jnp.asarray(deltas), interpret=True,
                                         sign=sign))
    got = _t(table)
    out = rows.scatter_add_sorted_rows(got, _t(ids), _t(deltas), sign=sign)
    assert out is got                              # in place
    assert np.array_equal(got.numpy(), want)
    # And the semantics, against numpy's sequential add.
    expected = table.copy()
    np.add.at(expected, ids, sign * deltas)
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-5)


def test_scatter_add_unsorted_wrapper_bitwise():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(32, 16)).astype(np.float32)
    ids = np.array([9, 2, 9, 31, 0, 2, 9, 9, 9, 2, 5], np.int32)
    deltas = rng.normal(size=(len(ids), 16)).astype(np.float32)
    want = np.asarray(jax_scatter(jnp.asarray(table), jnp.asarray(ids),
                                  jnp.asarray(deltas), interpret=True))
    got = rows.scatter_add_rows(_t(table), _t(ids), _t(deltas))
    assert np.array_equal(got.numpy(), want)


def test_scatter_add_rejects_scale_sign():
    with pytest.raises(ValueError):
        rows.scatter_add_sorted_rows(torch.zeros(4, 4), torch.zeros(1),
                                     torch.zeros(1, 4), sign=0.5)


def test_scatter_add_empty_is_noop():
    table = torch.ones(4, 8)
    rows.scatter_add_sorted_rows(table, torch.zeros(0, dtype=torch.int32),
                                 torch.zeros(0, 8))
    assert torch.equal(table, torch.ones(4, 8))


def test_kernel_modules_build_lazily():
    """Importing the kernel modules builds and loads nothing: the CUDA
    libraries are built at first launch on a card."""
    from multiverso_tpu_torch.ops import _build
    assert _build._libs == {}
    assert _build.BUILD_DIR.parts[-2:] == ("build", "multiverso_tpu_torch")
    assert set(_build.SOURCES) == {"rows", "sgns", "stateful_rows",
                                   "attention", "paged_attention"}
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
    # Only the stateful updaters' source is built without fused
    # multiply-adds; the other sources keep the common flags.
    assert _build._flags("stateful_rows") == \
        _build.NVCC_FLAGS + ["--fmad=false"]
    assert _build._flags("rows") == _build._flags("sgns") == \
        _build._flags("attention") == _build._flags("paged_attention") == \
        _build.NVCC_FLAGS
