"""Port parity of the sg-ns block step (B5) on id layouts that cross the
edges of the CUDA kernel's partition (``chip_smoke.sgns_layouts``: tiles
of 32 sorted slots, runs of up to 2 lanes held in registers, longer runs
staged by a warp, runs of ``LONG_RUN`` lanes or more streamed by a CTA in
32-lane tiles).

On the CPU the step runs its plain version; each case holds it against
the JAX package's ``build_sgns_grid_step`` in interpret mode on the same
numpy tables and streams, at the tolerance of ``test_torch_sgns.py``
(tables ``rtol=1e-5, atol=1e-6``, loss ``rtol=1e-5``: the two frameworks
implement sigmoid, log and sqrt separately and sum the dot products in
different orders). ``chip_smoke.py`` runs the same layouts through the
CUDA kernel against the plain version on the card.

The last test holds the kernel's gradient scratch on the CPU: an out-lane's
gradient row rebuilt as its coefficient times the snapshot of its
center's ``u`` equals ``_ns_grads``' ``grad_vpos`` / ``grad_vneg`` row
bitwise, in both frameworks.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_port
import chip_smoke
from multiverso_tpu.models.word2vec.model import _ns_grads as jax_ns_grads
from multiverso_tpu.ops.pallas_sgns import \
    build_sgns_grid_step as jax_grid_step

torch = sgns = model = None  # set by _load_port

C, N = 64, 3
# AdaGrad cases at test_torch_sgns.py's lr. SGD steps are not damped by a
# sum of squares: at lr 0.05 the row that takes all 256 out-lanes of a
# chunk (one_out_id) moves by ~3 per chunk, and then both float32 chains,
# JAX's and the port's, drift ~1.5e-5 from the same chain in float64,
# more than the tolerance. The SGD cases take lr 0.005.
LR = {True: 0.05, False: 0.005}
LONG_RUN = 32          # ops/sgns.py LONG_RUN (asserted below)
_LAYOUTS = {}          # (K, V) -> chip_smoke.sgns_layouts(...)
_JAX_STEPS = {}        # (K, adagrad) -> the jitted interpret-mode step


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, sgns, model
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.models.word2vec import model
    from multiverso_tpu_torch.ops import sgns


def _vocab(k):
    return 2048 if k > 8 else 512


def _layout(name, k):
    key = (k, _vocab(k))
    if key not in _LAYOUTS:
        _LAYOUTS[key] = chip_smoke.sgns_layouts(C, k, key[1], LONG_RUN, N)
    return _LAYOUTS[key][name]


NAMES = ("one_out_id", "long_edges", "held_edges", "tile_edges-3",
         "tile_edges-1", "tile_edges0", "tile_edges1", "tile_edges3",
         "tail_one_lane", "n_pairs_multiple", "out_of_range")
# (layout, K, D, adagrad): every layout at K=3, D=8 with AdaGrad; then
# K=1 and K=16, D=6 (not a multiple of 4) and SGD on a few layouts.
CASES = ([(name, 3, 8, True) for name in NAMES] +
         [("held_edges", 1, 8, True), ("long_edges", 1, 8, True),
          ("one_out_id", 16, 8, True), ("long_edges", 16, 8, True),
          ("tile_edges0", 16, 8, True), ("tile_edges0", 3, 6, True),
          ("long_edges", 3, 6, True), ("one_out_id", 3, 8, False),
          ("long_edges", 3, 8, False), ("held_edges", 3, 8, False),
          ("out_of_range", 3, 6, False)])


def _tables(k, d, seed):
    rng = np.random.default_rng(seed)
    v = _vocab(k)
    return [rng.normal(size=(v, d)).astype(np.float32),
            (0.5 * rng.normal(size=(v, d))).astype(np.float32),
            rng.uniform(0.0, 0.5, (v, d)).astype(np.float32),
            rng.uniform(0.0, 0.5, (v, d)).astype(np.float32)]


def _jax(tables, streams, n_pairs, k, adagrad):
    key = (k, adagrad)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jax_grid_step(chunk=C, negative=k, adagrad=adagrad,
                                        interpret=True)
    out = _JAX_STEPS[key](*[jnp.asarray(t.copy()) for t in tables],
                          *[jnp.asarray(s) for s in streams],
                          jnp.int32(n_pairs), jnp.float32(LR[adagrad]))
    return [np.asarray(t) for t in out[:4]], float(out[4])


def _port(tables, streams, n_pairs, k, adagrad):
    step = sgns.build_sgns_grid_step(chunk=C, negative=k, adagrad=adagrad)
    out = step(*[torch.as_tensor(t.copy()) for t in tables],
               *[torch.as_tensor(s) for s in streams],
               torch.tensor(n_pairs, dtype=torch.int32),
               np.float32(LR[adagrad]))
    return [t.numpy() for t in out[:4]], float(out[4])


def test_layouts_use_the_kernels_long_run():
    assert sgns.LONG_RUN == LONG_RUN
    runs = _layout("long_edges", 3)[1:3]
    out = np.concatenate([runs[0][0], runs[1][0].reshape(-1)])
    counts = np.unique(out, return_counts=True)[1]
    for n in (LONG_RUN - 1, LONG_RUN, LONG_RUN + 1):
        assert n in counts


@pytest.mark.parametrize(
    "name,k,d,adagrad", CASES,
    ids=[f"{n}-K{k}-D{d}-{'adagrad' if a else 'sgd'}"
         for n, k, d, a in CASES])
def test_plain_block_matches_jax_on_layout(name, k, d, adagrad):
    *streams, n_pairs = _layout(name, k)
    tables = _tables(k, d, seed=len(name) + 10 * k + d)
    want, want_loss = _jax(tables, streams, n_pairs, k, adagrad)
    got, got_loss = _port(tables, streams, n_pairs, k, adagrad)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert np.isfinite(got_loss)
    assert not np.array_equal(got[1], tables[1])     # it trained
    assert sgns.LAUNCHES["sgns_block"] == 0          # CPU: plain version


def test_coefficient_form_is_exact():
    """What the kernel's phase 1 keeps of an out-lane's gradient row: the
    coefficient (g_pos for the contexts, then g_neg in negatives.flatten()
    order) and the center's row u. Their product, rounded once, is the row
    ``_ns_grads`` computes, bit for bit, in both frameworks."""
    b, k, d = 37, 5, 24
    rng = np.random.default_rng(9)
    u = rng.normal(size=(b, d)).astype(np.float32)
    u[3, :5] = 0.0
    u[4, 5:9] = -0.0
    v_pos = rng.normal(size=(b, d)).astype(np.float32)
    v_neg = rng.normal(size=(b, k, d)).astype(np.float32)
    mask = (np.arange(b) < b - 6).astype(np.float32)   # a masked tail
    lanes = np.arange(b * (1 + k))
    pair = np.where(lanes < b, lanes, (lanes - b) // k)

    tu, tp, tn, tm = (torch.as_tensor(x) for x in (u, v_pos, v_neg, mask))
    _, _, grad_vpos, grad_vneg = model._ns_grads(tu, tp, tn, tm)
    g_pos = (torch.sigmoid((tu * tp).sum(-1)) - 1.0) * tm
    g_neg = torch.sigmoid((tu[:, None, :] * tn).sum(-1)) * tm[:, None]
    coef = torch.cat([g_pos, g_neg.reshape(-1)])
    rebuilt = coef[:, None] * tu.clone()[torch.as_tensor(pair)]
    want = torch.cat([grad_vpos, grad_vneg.reshape(b * k, d)])
    assert np.array_equal(rebuilt.numpy().view(np.int32),
                          want.numpy().view(np.int32))

    ju, jp, jn, jm = (jnp.asarray(x) for x in (u, v_pos, v_neg, mask))
    _, _, jgrad_vpos, jgrad_vneg = jax_ns_grads(ju, jp, jn, jm)
    jg_pos = (jax.nn.sigmoid(jnp.sum(ju * jp, axis=-1)) - 1.0) * jm
    jg_neg = jax.nn.sigmoid(jnp.einsum("bd,bkd->bk", ju, jn)) * jm[:, None]
    jcoef = jnp.concatenate([jg_pos, jg_neg.reshape(-1)])
    jrebuilt = jcoef[:, None] * ju[jnp.asarray(pair)]
    jwant = jnp.concatenate([jgrad_vpos, jgrad_vneg.reshape(b * k, d)])
    assert np.array_equal(np.asarray(jrebuilt).view(np.int32),
                          np.asarray(jwant).view(np.int32))
