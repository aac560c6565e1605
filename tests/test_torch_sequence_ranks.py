"""Port parity: ring and Ulysses attention over a sequence group of 2 and 4
ranks against the JAX package's ``shard_map`` programs on a ``"seq"`` mesh
of as many devices, and the differentiable collectives under them.

The port side is one gloo world of n rank processes on 127.0.0.1
(``tests/_torch_ranks.py``'s ``seq_attn`` case, one world per n for the
module): each rank runs every variant on its sequence block of the same
numpy q, k, v (``ATTN_SHAPE``, seeded), and the blocks are put back in rank
order here. With ``-flash_attention`` on, the JAX side runs its Pallas
kernel in interpret mode and the port B6's plain version (the CPU path).
Both compute the exact softmax, so they agree within float32 rounding of
differently ordered sums: ``rtol=2e-5, atol=2e-6``, the JAX flash tests'
tolerance (``test_torch_sequence.py``'s).

The collectives at n = 2: ``ring_shift`` and ``all_to_all``, each composed
with its inverse around a float64 weight (a function local to each rank,
so ``torch.autograd.gradcheck`` runs on both ranks in step), pass
gradcheck at its default tolerances; their gradients across ranks are
exact (each is a permutation of the cotangents).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import _torch_port
from multiverso_tpu.parallel import sequence as jax_seq
from multiverso_tpu.utils.configure import reset_flags as jax_reset_flags
from multiverso_tpu.utils.configure import set_flag as jax_set_flag

ranks = None   # set by _load_port

TOL = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global ranks
    _torch_port.load_torch()
    import _torch_ranks as ranks


def _world(tmp_path_factory, n):
    out = str(tmp_path_factory.mktemp(f"seq{n}"))
    res = ranks.run_world(out, "seq_attn", n)
    arrays = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
              for r in range(n)]
    return res, arrays


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, 4)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["ring", "ulysses"])
@pytest.mark.parametrize("n", [2, 4])
def test_ranks_match_jax_on_a_seq_mesh(request, n, mode, causal, flash):
    res, arrays = request.getfixturevalue(f"world{n}")
    assert [r["axis_index"] for r in res] == list(range(n))
    got = np.concatenate([a[f"{mode}_{int(causal)}_{int(flash)}"]
                          for a in arrays], axis=2)
    q, k, v = ranks.attn_inputs()
    jax_fn = (jax_seq.ring_attention if mode == "ring"
              else jax_seq.ulysses_attention)
    jax_set_flag("flash_attention", flash)
    try:
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
        want = np.asarray(jax_fn(*(jnp.asarray(t) for t in (q, k, v)), mesh,
                                 causal=causal))
    finally:
        jax_reset_flags()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fn", ["ring_shift", "all_to_all"])
def test_collectives_pass_gradcheck_at_two_ranks(world2, fn):
    res, _ = world2
    assert all(r[f"gradcheck_{fn}"] for r in res), res


def test_collective_gradients_cross_the_ranks(world2):
    """``ring_shift``: y_r = x_(r-1), so with loss = sum_r c_r . y_r the
    gradient of x_r is c_(r+1) (c_r = r + 1). ``all_to_all`` (split dim 1
    over the ranks, concatenate on dim 2): rank r receives rows [2r, 2r+2)
    of every rank's x, so x's gradient is c_r on those rows. Its forward
    against the numpy layout swap."""
    torch = _torch_port.load_torch()
    _, arrays = world2
    xs = [torch.randn((2, 4, 3), generator=torch.Generator().manual_seed(r),
                      dtype=torch.float64).numpy() for r in range(2)]
    by_rows = np.concatenate([np.ones((2, 2, 3)), np.full((2, 2, 3), 2.0)],
                             axis=1)
    for r in range(2):
        np.testing.assert_array_equal(arrays[r]["shift_grad"],
                                      np.full((2, 4, 3), (r + 1) % 2 + 1.0))
        np.testing.assert_array_equal(arrays[r]["a2a_grad"], by_rows)
        swap = np.concatenate([x[:, 2 * r:2 * r + 2] for x in xs], axis=2)
        np.testing.assert_array_equal(arrays[r]["a2a_fwd"], swap)
