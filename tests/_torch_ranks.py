"""Rank processes of the port's two-rank tests on the CPU.

``tests/test_torch_collectives.py`` starts two of these per case:

    python tests/_torch_ranks.py <case> <rank> <out_dir> [case arguments]

Each joins a gloo world of two ranks on loopback through ``mv.init``,
runs its case, writes ``rank<r>.json`` (and ``rank<r>.npz`` with the
arrays the parent checks) into ``out_dir``, and exits 0. The cases take
their inputs from fixed seeds, so the parent can rebuild every input.
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def lr_data(F=24, B=16, N=8, seed=0):
    """``tests/test_comm_policy.py::_lr_data``: N minibatches of B rows."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N * B, F + 1)).astype(np.float32)
    X[:, -1] = 1.0
    w_true = rng.normal(size=(F + 1, 1)).astype(np.float32)
    y = (X @ w_true > 0).astype(np.float32).ravel()
    return [(X[i * B:(i + 1) * B], y[i * B:(i + 1) * B])
            for i in range(N)], F, B


def lr_config(mod, F, B, **kw):
    return mod.LogRegConfig(objective="sigmoid", num_feature=F,
                            learning_rate=0.1, minibatch_size=B, **kw)


# word2vec's two-rank model average: bench-shaped but tiny.
W2V_V, W2V_SENTS, W2V_LEN = 200, 16, 20


def w2v_corpus():
    """The dictionary's counts and both ranks' sentences (rank r takes
    sentences r, r + 2, ...)."""
    from multiverso_tpu_torch.models.word2vec import Dictionary
    d, zipf = Dictionary.synthetic_zipf(W2V_V, 20_000)
    rng = np.random.default_rng(4)
    sents = [rng.choice(W2V_V, size=int(rng.integers(8, W2V_LEN + 1)),
                        p=zipf).astype(np.int32) for _ in range(W2V_SENTS)]
    return d, sents


def w2v_kwargs(**over):
    kw = dict(embedding_size=16, window=3, negative=3, batch_size=16,
              sample=1e-3, optimizer="adagrad", epochs=1, pipeline=False,
              device_pipeline=False, block_words=40, scan_group=3, seed=0)
    kw.update(over)
    return kw


def _init(rank: int, coordinator: str, *extra):
    import torch
    torch.set_num_threads(1)
    import multiverso_tpu_torch as mv
    mv.init(["-platform=cpu", f"-coordinator={coordinator}",
             "-world_size=2", f"-rank={rank}", *extra])
    return mv


def case_world(rank: int, out: str, coordinator: str) -> dict:
    """Start-up, the collectives, the AUTO probe, logreg's data-parallel
    allreduce and model average, and word2vec's model average."""
    import torch
    mv = _init(rank, coordinator)
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.parallel import collectives as col
    from multiverso_tpu_torch.parallel import comm_policy as cp
    mesh = Zoo.get().mesh
    res = {"rank": mv.rank(), "size": mv.size(),
           "mesh": mesh.shape, "axis_index": mesh.axis_index("server")}
    mv.barrier()
    arrays = {}
    rng = np.random.default_rng(100 + rank)
    vec = rng.normal(size=8).astype(np.float32)
    mat = rng.normal(size=(4, 3)).astype(np.float32)
    arrays["agg_vec"] = mv.aggregate(vec)
    arrays["agg_mat"] = mv.aggregate(mat)
    tensor_sum = mv.aggregate(torch.as_tensor(mat))
    res["agg_tensor_is_tensor"] = isinstance(tensor_sum, torch.Tensor)
    arrays["agg_tensor"] = tensor_sum.numpy()
    # The JAX functions' shards: this rank's slice of a global [4, 3]
    # input, and of a whole [4, 3] contribution for the reduce-scatter.
    shard = torch.as_tensor(rng.normal(size=(2, 3)).astype(np.float32))
    whole = torch.as_tensor(rng.normal(size=(4, 3)).astype(np.float32))
    arrays["shard"], arrays["whole"] = shard.numpy(), whole.numpy()
    arrays["allreduce"] = col.device_allreduce(shard, mesh).numpy()
    arrays["allgather"] = col.device_allgather(shard, mesh).numpy()
    arrays["reduce_scatter"] = col.device_reduce_scatter(whole, mesh).numpy()
    # The JAX function's input is one replicated array: every rank
    # contributes the same one.
    same = torch.as_tensor(np.random.default_rng(7).normal(size=(4, 3))
                           .astype(np.float32))
    arrays["reduce_scatter_same"] = col.device_reduce_scatter(
        same, mesh).numpy()
    arrays["dense_sync"] = cp.build_dense_sync(mesh)(
        torch.as_tensor(vec)).numpy()
    arrays["dense_sync_same"] = cp.build_dense_sync(mesh)(
        torch.as_tensor([3.0, 0.125, 17.5, 1e-3])).numpy()
    # AUTO at world 2: both ranks measure, agree and decide alike.
    lat = cp.measured_policy_latency_ms(256, mesh, world=2)
    table = mv.create_table(mv.ArrayTableOption(size=64, comm_policy="auto",
                                                name="auto_probe"))
    res["probe"] = {k: lat[k] for k in (cp.PS, cp.ALLREDUCE, "world")}
    res["auto_policy"] = table.comm_policy
    res["auto_want"] = (cp.PS if lat[cp.PS] < lat[cp.ALLREDUCE]
                        else cp.ALLREDUCE)

    # logreg allreduce over the data-parallel axis: each rank takes its
    # half of every minibatch.
    from multiverso_tpu_torch.models import logreg as tlr
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    batches, F, B = lr_data()
    cfg = lr_config(tlr, F, B, comm_policy="allreduce")
    dp = tlr.AllreduceModel(cfg, dp_mesh=mesh, dp_axis="server")
    half = B // 2
    res["dp_losses"] = [
        float(dp.update(X[rank * half:(rank + 1) * half],
                        y[rank * half:(rank + 1) * half]))
        for X, y in batches]
    arrays["dp_weights"] = dp.get_weights()
    # logreg model average: rank r trains batches r, r + 2, ...; each
    # epoch ends in the merge.
    cfg_ma = lr_config(tlr, F, B, comm_policy="model_average", epochs=2)
    ma = tlr.make_model(cfg_ma)
    res["ma_model"] = type(ma).__name__
    res["ma_losses"] = [float(x) for x in
                        LogReg(cfg_ma, model=ma).train(batches[rank::2])]
    arrays["ma_weights"] = ma.get_weights()
    arrays["ma_table"] = ma.table.get()

    # word2vec model average: one epoch on this rank's sentences, then
    # the merge; the tables are kept just before and after it.
    from multiverso_tpu_torch.models.word2vec import Word2Vec, Word2VecConfig
    d, sents = w2v_corpus()
    w = Word2Vec(Word2VecConfig(**w2v_kwargs(comm_policy="model_average")),
                 d)
    names = ("input_table", "output_table", "adagrad_in", "adagrad_out")
    merge = w._model_average_epoch

    def kept_merge():
        for name in names:
            arrays[f"pre_{name}"] = getattr(w, name).get()
        merge()

    w._model_average_epoch = kept_merge
    stats = w.train(sentences=sents[rank::2])
    res["w2v"] = {"comm_mode": stats["comm_mode"], "words": stats["words"],
                  "pairs": stats["pairs"]}
    for name in names:
        arrays[f"post_{name}"] = getattr(w, name).get()
    from multiverso_tpu_torch.telemetry import get_registry
    counters = get_registry().snapshot(buckets=False)["counters"]
    res["host_copies"] = counters.get("comm.collective.host_copies",
                                      {}).get("value", 0)
    res["ma_bytes"] = counters["comm.model_average.bytes"]["value"]
    # Both ranks checkpoint every table into one shared directory.
    from multiverso_tpu_torch.core.checkpoint import save_all
    res["ckpt_root"] = save_all(os.path.join(out, "ckpt"), step=1)
    res["tables"] = [t.name for t in Zoo.get().tables]
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    mv.shutdown()
    return res


def case_machine_file(rank: int, out: str, machine_file: str,
                      route_address: str) -> dict:
    """``-machine_file`` start-up on a host whose name resolves to
    loopback only: this rank finds itself through the default route's
    source address (``route_address``, handed in by a stand-in socket
    module that net_util sees in place of ``socket``; no socket opens)."""
    import socket as real

    import torch
    torch.set_num_threads(1)
    from multiverso_tpu_torch.utils import net_util

    class _Probe:
        def __init__(self, *a):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def connect(self, addr):
            pass

        def getsockname(self):
            return (route_address, 40000)

    class _Socket:
        AF_INET, SOCK_DGRAM, gaierror = real.AF_INET, real.SOCK_DGRAM, \
            real.gaierror
        socket = _Probe

        @staticmethod
        def gethostname():
            return "mv-test-host"

        @staticmethod
        def getaddrinfo(host, port):
            return [(real.AF_INET, real.SOCK_STREAM, 6, "",
                     ("127.0.1.1", 0))]

    net_util.socket = _Socket
    import multiverso_tpu_torch as mv
    mv.init(["-platform=cpu", f"-machine_file={machine_file}"])
    from multiverso_tpu_torch.utils.configure import get_flag
    res = {"rank": mv.rank(), "size": mv.size(),
           "coordinator": get_flag("coordinator")}
    mv.barrier()
    res["sum"] = mv.aggregate(np.full(3, float(rank + 1), np.float32)
                              ).tolist()
    mv.shutdown()
    return res


CASES = {"world": case_world, "machine_file": case_machine_file}


def main() -> int:
    case, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    res = CASES[case](rank, out, *sys.argv[4:])
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
