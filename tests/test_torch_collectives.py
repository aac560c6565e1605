"""The port's collective plane against the JAX package and numpy.

Mirrors ``tests/test_multiprocess.py`` (slow in the JAX package: two jax
processes over the coordination service) with two rank processes of the
port over gloo on 127.0.0.1 (``tests/_torch_ranks.py``): start-up,
``rank``/``size``/``barrier``, ``mv.aggregate`` of 1-D and 2-D arrays and
of a tensor, the all-gather and reduce-scatter, the dense merge, the AUTO
probe at world 2, logreg's data-parallel allreduce
(``test_comm_policy.py::test_logreg_allreduce_dp_psum_matches_single`` at
two ranks) and model average, word2vec's model average, and the
``-machine_file`` start-up. Each rank process has a timeout of its own,
and a hang fails the test. The one-process cases hold the collectives at
world size 1 against the JAX functions, the rank mesh against the JAX
mesh spec, and the machine file's rank rule of both packages on a host
whose name resolves to loopback only (ROADMAP C8's witness).

Tolerances: every collective is bitwise (a sum of two float32 values does
not depend on its order); the data-parallel logreg losses within rel
1e-5 and weights within atol 1e-6 of one contributor (the JAX test's);
word2vec's merged tables bitwise the mean of the two ranks' tables, and
within rtol 1e-5 / atol 1e-6 of the JAX package's one-process runs on
each shard, averaged in numpy (the word2vec host path's tolerance,
``tests/test_torch_word2vec_variants.py``).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import _torch_port
import jax

import multiverso_tpu as mvj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(REPO, "tests", "_torch_ranks.py")
RANK_TIMEOUT_S = 60
W2V_TOL = dict(rtol=1e-5, atol=1e-6)

mvt = ranks = None   # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global mvt, ranks
    _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _torch_ranks as ranks


@pytest.fixture(autouse=True)
def _port_state():
    yield
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.telemetry import reset_telemetry
    from multiverso_tpu_torch.utils.configure import reset_flags
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        zoo.stop()
    Zoo._reset_for_tests()
    reset_flags()
    reset_telemetry()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(out_dir: str, case: str, args_per_rank) -> list:
    """Two rank processes of ``case``; returns each rank's JSON result."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, RANKS, case, str(r), out_dir, *args_per_rank[r]],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {r} of '{case}' hung past "
                            f"{RANK_TIMEOUT_S} s")
            assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                outs.append(json.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One two-rank run of ``case_world``: the JSON and arrays of each
    rank."""
    out = str(tmp_path_factory.mktemp("world"))
    res = run_ranks(out, "world",
                    [[f"127.0.0.1:{_free_port()}"]] * 2)
    arrays = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
              for r in range(2)]
    return res, arrays


def _inputs(rank):
    """``case_world``'s per-rank inputs, rebuilt from its seeds."""
    rng = np.random.default_rng(100 + rank)
    vec = rng.normal(size=8).astype(np.float32)
    mat = rng.normal(size=(4, 3)).astype(np.float32)
    return vec, mat


# -- two ranks ---------------------------------------------------------------
def test_two_rank_start_up_and_aggregate(world):
    """``mv.init`` with -coordinator/-world_size/-rank; ``mv.aggregate``
    of 1-D and 2-D arrays and of a tensor is the elementwise sum on both
    ranks (the ``Test/test_allreduce.cpp:11-20`` invariant at world 2)."""
    res, arrays = world
    (v0, m0), (v1, m1) = _inputs(0), _inputs(1)
    for r in range(2):
        assert (res[r]["rank"], res[r]["size"]) == (r, 2)
        assert res[r]["mesh"] == {"server": 2}
        assert res[r]["axis_index"] == r
        assert np.array_equal(arrays[r]["agg_vec"], v0 + v1)
        assert np.array_equal(arrays[r]["agg_mat"], m0 + m1)
        assert res[r]["agg_tensor_is_tensor"]
        assert np.array_equal(arrays[r]["agg_tensor"], m0 + m1)


def test_two_rank_collectives_match_jax(world):
    """All-reduce, all-gather and reduce-scatter over the mesh's server
    axis: against numpy, and each rank's part of the JAX functions'
    output on a 2-device mesh fed the ranks' parts of their input."""
    from jax.sharding import Mesh
    from multiverso_tpu.parallel import collectives as jcol
    from multiverso_tpu.parallel import comm_policy as jcp
    _, arrays = world
    shards = [a["shard"] for a in arrays]
    glob = np.concatenate(shards)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("server",))
    j_ar = np.asarray(jcol.device_allreduce(glob, mesh, "server"))
    j_ag = np.asarray(jcol.device_allgather(glob, mesh, "server"))
    same = np.random.default_rng(7).normal(size=(4, 3)).astype(np.float32)
    j_rs = np.asarray(jcol.device_reduce_scatter(same, mesh, "server"))
    j_sync = np.asarray(jcp.build_dense_sync(mesh, "server")(
        np.asarray([3.0, 0.125, 17.5, 1e-3], np.float32)))
    wholes = [a["whole"] for a in arrays]
    for r in range(2):
        assert np.array_equal(arrays[r]["allreduce"], shards[0] + shards[1])
        assert np.array_equal(arrays[r]["allreduce"], j_ar)
        assert np.array_equal(arrays[r]["allgather"], glob)
        assert np.array_equal(arrays[r]["allgather"], j_ag)
        want = (wholes[0] + wholes[1])[2 * r:2 * r + 2]
        assert np.array_equal(arrays[r]["reduce_scatter"], want)
        assert np.array_equal(arrays[r]["reduce_scatter_same"],
                              j_rs[2 * r:2 * r + 2])
        assert np.array_equal(arrays[r]["dense_sync_same"], j_sync)
    (v0, _), (v1, _) = _inputs(0), _inputs(1)
    assert np.array_equal(arrays[0]["dense_sync"], (v0 + v1) / 2)
    assert np.array_equal(arrays[0]["dense_sync"], arrays[1]["dense_sync"])


def test_two_rank_auto_probe_agrees(world):
    """The AUTO probe at world 2: a real all-reduce leg, readings agreed
    over the world, so both ranks take the same, argmin decision."""
    res, _ = world
    assert res[0]["probe"] == res[1]["probe"]
    assert res[0]["probe"]["world"] == 2
    for r in range(2):
        assert res[r]["auto_policy"] == res[r]["auto_want"]
    assert res[0]["probe"]["allreduce"] > 0 and res[0]["probe"]["ps"] > 0


def test_two_rank_logreg_allreduce_dp_matches_single(world):
    """Mirror of ``test_logreg_allreduce_dp_psum_matches_single`` at two
    ranks: each rank steps on half of every minibatch and the gradient is
    all-reduced; losses within rel 1e-5 and weights within atol 1e-6 of
    the one-contributor step on whole minibatches."""
    from multiverso_tpu_torch.models import logreg as tlr
    res, arrays = world
    batches, F, B = ranks.lr_data()
    mvt.init(["-platform=cpu"])
    single = tlr.AllreduceModel(ranks.lr_config(tlr, F, B,
                                                comm_policy="allreduce"))
    want = [float(single.update(X, y)) for X, y in batches]
    for r in range(2):
        assert res[r]["dp_losses"] == pytest.approx(want, rel=1e-5)
        np.testing.assert_allclose(arrays[r]["dp_weights"],
                                   single.get_weights(), rtol=0, atol=1e-6)
    assert np.array_equal(arrays[0]["dp_weights"], arrays[1]["dp_weights"])


def test_two_rank_logreg_model_average_merges(world):
    """logreg ``model_average`` at two ranks: every epoch ends in the
    merge, so both ranks end on the same weights, published to their
    tables."""
    res, arrays = world
    for r in range(2):
        assert res[r]["ma_model"] == "ModelAverageModel"
        assert np.isfinite(res[r]["ma_losses"]).all()
        assert np.array_equal(arrays[r]["ma_table"].reshape(-1),
                              arrays[r]["ma_weights"].reshape(-1))
    assert np.array_equal(arrays[0]["ma_weights"], arrays[1]["ma_weights"])


def test_two_rank_word2vec_model_average(world):
    """word2vec ``model_average`` at two ranks: after the epoch each
    rank's tables are bitwise the mean of both ranks' pre-merge tables,
    and within the word2vec tolerance of the JAX package's one-process
    runs on each rank's shard, averaged in numpy."""
    from multiverso_tpu.models.word2vec import Dictionary as JaxDictionary
    from multiverso_tpu.models.word2vec import Word2Vec as JaxWord2Vec
    from multiverso_tpu.models.word2vec import Word2VecConfig as JaxConfig
    res, arrays = world
    names = ("input_table", "output_table", "adagrad_in", "adagrad_out")
    for name in names:
        mean = (arrays[0][f"pre_{name}"] + arrays[1][f"pre_{name}"]) \
            / np.float32(2)
        for r in range(2):
            assert np.array_equal(arrays[r][f"post_{name}"], mean), name
    for r in range(2):
        assert res[r]["w2v"]["comm_mode"] == "model_average"
        assert res[r]["w2v"]["pairs"] > 0
        assert res[r]["ma_bytes"] > 0
    _, sents = ranks.w2v_corpus()
    jd = JaxDictionary.synthetic_zipf(ranks.W2V_V, 20_000)[0]
    shards = []
    for r in range(2):
        mvj.init([], devices=jax.devices()[:1])
        try:
            jw = JaxWord2Vec(JaxConfig(**ranks.w2v_kwargs()), jd)
            jw.train(sentences=sents[r::2])
            shards.append({n: getattr(jw, n).get() for n in names})
        finally:
            mvj.shutdown()
    for name in names:
        for r in range(2):
            np.testing.assert_allclose(arrays[r][f"pre_{name}"],
                                       shards[r][name], err_msg=name,
                                       **W2V_TOL)
        np.testing.assert_allclose(
            arrays[0][f"post_{name}"],
            (shards[0][name] + shards[1][name]) / np.float32(2),
            err_msg=name, **W2V_TOL)


def test_two_rank_checkpoint_names_each_rank(world):
    """``save_all`` from both ranks into one directory: rank 0 keeps the
    plain names, rank 1's manifest and files carry its rank, as the JAX
    module names them, so the two never collide."""
    from multiverso_tpu.core import checkpoint as jck
    res, _ = world
    root = res[0]["ckpt_root"]
    assert res[1]["ckpt_root"] == root
    names = set(os.listdir(root))
    assert {jck._meta_name(0), jck._meta_name(1)} <= names
    with open(os.path.join(root, jck._meta_name(1))) as f:
        files = json.load(f)["files"]
    assert sorted(files) == sorted(set(res[1]["tables"]))
    assert all(v.endswith("-r1.npz") and v in names for v in files.values())
    with open(os.path.join(root, jck._meta_name(0))) as f:
        assert all("-r" not in v for v in json.load(f)["files"].values())


def test_two_rank_machine_file_start_up(tmp_path):
    """``-machine_file`` start-up: each rank finds its line through the
    default route's source address on a host whose name resolves to
    loopback only (C8), and the group's coordinator is rank 0's entry at
    its port + 1."""
    coord = _free_port()
    mf = tmp_path / "machines"
    mf.write_text(f"127.0.0.2:{coord - 1}\n127.0.0.3:{coord + 7}\n")
    res = run_ranks(str(tmp_path), "machine_file",
                    [[str(mf), "127.0.0.2"], [str(mf), "127.0.0.3"]])
    for r in range(2):
        assert (res[r]["rank"], res[r]["size"]) == (r, 2)
        assert res[r]["coordinator"] == f"127.0.0.2:{coord}"
        assert res[r]["sum"] == [3.0, 3.0, 3.0]


# -- one process -------------------------------------------------------------
@pytest.fixture
def fake_host(monkeypatch):
    """ROADMAP C8's host: its name resolves to loopback only, and the
    default route's source address (what a UDP ``connect`` reports) is
    10.20.30.40. The socket module is patched for both packages; the
    stand-in socket opens nothing."""
    class Probe:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def connect(self, addr):
            self.peer = addr

        def getsockname(self):
            return ("10.20.30.40", 40000)

    monkeypatch.setattr(socket, "gethostname", lambda: "mv-test-host")
    monkeypatch.setattr(socket, "getaddrinfo", lambda host, port: [
        (socket.AF_INET, socket.SOCK_STREAM, 6, "", ("127.0.1.1", 0))])
    monkeypatch.setattr(socket, "socket", Probe)
    return "10.20.30.40"


def test_local_ips_find_the_routable_address(fake_host):
    """C8: both packages' ``get_local_ips`` include the default route's
    source address on a host whose name resolves to loopback only."""
    from multiverso_tpu.utils import net_util as jnu
    from multiverso_tpu_torch.utils import net_util as tnu
    got = tnu.get_local_ips()
    assert fake_host in got and "127.0.1.1" in got
    assert got == jnu.get_local_ips()


def test_machine_file_rank_without_local_ips_matches_jax(fake_host,
                                                         tmp_path):
    """C8: ``rank_from_machine_file`` without ``local_ips`` gives both
    packages the same rank, found through the routable address."""
    from multiverso_tpu.utils import net_util as jnu
    from multiverso_tpu_torch.utils import net_util as tnu
    path = tmp_path / "machines"
    path.write_text(f"10.0.0.1:7000\n{fake_host}:7001\n10.0.0.3:7002\n")
    want = jnu.rank_from_machine_file(str(path))
    assert want[:2] == (1, 3)
    assert tnu.rank_from_machine_file(str(path)) == want


def test_one_rank_collectives_are_the_jax_functions_on_one_device():
    """At world size 1 (no process group) every collective is the
    identity, as the JAX functions are on a 1-device mesh."""
    import torch
    from jax.sharding import Mesh
    from multiverso_tpu.parallel import collectives as jcol
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.parallel import collectives as tcol
    mvt.init(["-platform=cpu"])
    mesh = Zoo.get().mesh
    assert mesh.shape == {"server": 1} and mesh.group("server") is None
    x = np.random.default_rng(3).normal(size=(4, 3)).astype(np.float32)
    jmesh = Mesh(np.asarray(jax.devices()[:1]), ("server",))
    for tfn, jfn in ((tcol.device_allreduce, jcol.device_allreduce),
                     (tcol.device_allgather, jcol.device_allgather),
                     (tcol.device_reduce_scatter,
                      jcol.device_reduce_scatter)):
        got = tfn(torch.as_tensor(x), mesh)
        assert np.array_equal(got.numpy(), np.asarray(jfn(x, jmesh)))
    assert np.array_equal(mvt.aggregate(x), np.asarray(jcol.aggregate(x)))
    t = torch.as_tensor(x)
    got = mvt.aggregate(t)
    assert torch.equal(got, t) and got is not t
    assert tcol.world_size() == 1


def test_rank_mesh_spec_and_slices():
    """``-mesh_shape`` parses as the JAX package's; the axes must cover
    the world; an axis's slices are the ranks that differ only in that
    coordinate, in one fixed order."""
    from multiverso_tpu.parallel import mesh as jmesh
    from multiverso_tpu_torch.parallel import mesh as tmesh
    for spec in ("server:2,worker:4", " server : 8 ", "a:1,b:2,c:3", ""):
        assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)
    assert (tmesh.SERVER_AXIS, tmesh.WORKER_AXIS) == \
        (jmesh.SERVER_AXIS, jmesh.WORKER_AXIS)
    ranks_ = np.arange(6).reshape(2, 3)
    assert list(tmesh._slices(ranks_, 0)) == [[0, 3], [1, 4], [2, 5]]
    assert list(tmesh._slices(ranks_, 1)) == [[0, 1, 2], [3, 4, 5]]
    mvt.init(["-platform=cpu", "-mesh_shape=server:1,worker:1"])
    from multiverso_tpu_torch.core.zoo import Zoo
    mesh = Zoo.get().mesh
    assert mesh.shape == {"server": 1, "worker": 1}
    assert mesh.axis_index("worker") == 0 and mesh.axis_size("expert") == 1
    mvt.shutdown()
    with pytest.raises(ValueError, match="world has 1 ranks"):
        mvt.init(["-platform=cpu", "-mesh_shape=server:2"])
