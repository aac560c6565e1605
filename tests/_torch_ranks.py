"""Rank processes of the port's multi-rank tests on the CPU.

``tests/test_torch_collectives.py`` starts two of these per case, and the
long-context LM's tests (``tests/test_torch_*_ranks.py``,
``tests/test_torch_pipeline.py``) two or four through :func:`run_world`:

    python tests/_torch_ranks.py <case> <rank> <out_dir> [case arguments]

Each joins a gloo world on loopback through ``mv.init``, runs its case,
writes ``rank<r>.json`` (and ``rank<r>.npz`` with the arrays the parent
checks) into ``out_dir``, and exits 0. The cases take their inputs from
fixed seeds (or from ``inputs.npz``, which the parent writes into
``out_dir`` first), so the parent can rebuild every input.
"""

import json
import os
import socket
import subprocess
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


# ---------------------------------------------------------------------------
# The long-context LM across ranks: ring and Ulysses, the differentiable
# collectives, the LM at data x seq, the 1F1B pipeline.
# ---------------------------------------------------------------------------
RANK_TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(out_dir: str, case: str, n: int, *args) -> list:
    """``n`` rank processes of ``case`` (each ``args``); returns each
    rank's JSON result. A rank that fails or outlives RANK_TIMEOUT_S
    raises, naming its output's tail."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r), out_dir,
         str(n), coordinator, *map(str, args)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(n)]
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {r} of '{case}' hung past "
                                     f"{RANK_TIMEOUT_S} s")
            if p.returncode != 0:
                raise AssertionError(f"rank {r} of '{case}' failed:\n"
                                     f"{err[-3000:]}")
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                outs.append(json.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _world(rank: int, n: int, coordinator: str, mesh_shape: str):
    import torch
    torch.set_num_threads(1)
    import multiverso_tpu_torch as mv
    mv.init(["-platform=cpu", f"-coordinator={coordinator}",
             f"-world_size={n}", f"-rank={rank}",
             f"-mesh_shape={mesh_shape}"])
    from multiverso_tpu_torch.core.zoo import Zoo
    return mv, Zoo.get().mesh


#: Ring and Ulysses inputs: [B, H, S, D] (S = 512: the JAX flash gate's
#: 128-row blocks hold at four ranks).
ATTN_SHAPE = (1, 4, 512, 32)


def attn_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=ATTN_SHAPE).astype(np.float32)
            for _ in range(3)]


def case_seq_attn(rank: int, out: str, n: str, coordinator: str) -> dict:
    """Ring and Ulysses attention over a sequence group of n ranks, causal
    and not, -flash_attention off and on, on this rank's block; and at
    n = 2 the differentiable collectives: gradcheck in float64 of
    ring_shift and all_to_all composed with their inverses, and each
    one's gradient across ranks."""
    import torch
    n = int(n)
    mv, mesh = _world(rank, n, coordinator, f"seq:{n}")
    from multiverso_tpu_torch.parallel import collectives as col
    from multiverso_tpu_torch.parallel import sequence as seq
    from multiverso_tpu_torch.utils.configure import set_flag
    group = mesh.group("seq")
    res = {"rank": rank, "axis_index": mesh.axis_index("seq")}
    blk = ATTN_SHAPE[2] // n
    q, k, v = (torch.as_tensor(t[:, :, rank * blk:(rank + 1) * blk])
               for t in attn_inputs())
    arrays = {}
    for flash in (False, True):
        set_flag("flash_attention", flash)
        for causal in (False, True):
            for mode in ("ring", "ulysses"):
                fn = (seq.ring_attention if mode == "ring"
                      else seq.ulysses_attention)
                arrays[f"{mode}_{int(causal)}_{int(flash)}"] = fn(
                    q, k, v, group, causal=causal).numpy()
    set_flag("flash_attention", False)
    if n == 2:
        g = torch.Generator().manual_seed(rank)
        x = torch.randn((2, 4, 3), generator=g, dtype=torch.float64,
                        requires_grad=True)
        w = torch.randn((2, 4, 3), generator=g, dtype=torch.float64)

        def shift_back(t):
            return col.ring_shift(col.ring_shift(t, group) * w, group,
                                  step=-1)

        w2 = torch.randn((2, 2, 6), generator=g, dtype=torch.float64)

        def swap_back(t):               # [2, 4, 3] -> [2, 2, 6] and back
            return col.all_to_all(col.all_to_all(t, group, 1, 2) * w2,
                                  group, 2, 1)

        res["gradcheck_ring_shift"] = bool(torch.autograd.gradcheck(
            shift_back, (x,)))
        res["gradcheck_all_to_all"] = bool(torch.autograd.gradcheck(
            swap_back, (x,)))
        # Across ranks: y = shift(x) and loss = sum(y * c_r), so x's
        # gradient on rank r is the next rank's c.
        c = torch.full((2, 4, 3), float(rank + 1), dtype=torch.float64)
        x2 = x.detach().clone().requires_grad_(True)
        (col.ring_shift(x2, group) * c).sum().backward()
        arrays["shift_grad"] = x2.grad.numpy()
        x3 = x.detach().clone().requires_grad_(True)
        (col.all_to_all(x3, group, 1, 2) * float(rank + 1)).sum().backward()
        arrays["a2a_grad"] = x3.grad.numpy()
        arrays["a2a_fwd"] = col.all_to_all(x.detach(), group, 1, 2).numpy()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    mv.shutdown()
    return res


LM_SMALL = dict(vocab=61, dim=32, heads=4, layers=2, seq=256)


def lm_tokens(seed: int, B: int = 2, S: int = 256, vocab: int = 61):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def case_lm(rank: int, out: str, n: str, coordinator: str, mesh_shape: str,
            cfg_json: str) -> dict:
    """The LM on a mesh of n ranks from the JAX parameters in
    ``inputs.npz``: loss() (flag off, then on), the gradient of one batch
    (summed over the mesh), then 3 fit steps; rank 0 writes the arrays,
    every rank a digest of its parameters."""
    import hashlib
    import torch
    n = int(n)
    mv, mesh = _world(rank, n, coordinator, mesh_shape)
    from multiverso_tpu_torch import interop
    from multiverso_tpu_torch.models import attention_lm as lm
    from multiverso_tpu_torch.utils.configure import set_flag
    cfg = lm.LMConfig(**json.loads(cfg_json))
    model = lm.AttentionLM(cfg, device=torch.device("cpu"), mesh=mesh)
    params = dict(np.load(os.path.join(out, "inputs.npz")))
    interop.load_attention_lm_params(model, params)
    res = {"rank": rank, "shard": [model.shard.data_index,
                                   model.shard.seq_index]}
    arrays = {}
    tokens = lm_tokens(0, B=4 if cfg.pipeline_stages else 2)
    res["loss"] = model.loss(tokens)
    if not cfg.pipeline_stages:
        set_flag("flash_attention", True)
        res["loss_flash"] = model.loss(tokens)
        set_flag("flash_attention", False)
        loss = lm.next_token_loss(model.params, model._tokens(lm_tokens(1)),
                                  cfg, model.shard)
        loss.backward()
        model._sum_grads(model.shard.group)
        res["grad_loss"] = float(loss)
        for name, p in model.params.items():
            arrays[f"grad/{name}"] = p.grad.numpy()
            p.grad = None
    batches = [lm_tokens(10 + i, B=4 if cfg.pipeline_stages else 2)
               for i in range(3)]
    res["fit"] = model.fit(batches)
    digest = hashlib.sha256()
    for name, p in sorted(model.params.items()):
        arrays[f"param/{name}"] = p.detach().numpy()
        digest.update(p.detach().numpy().tobytes())
    res["digest"] = digest.hexdigest()
    res["loss_after"] = model.loss(tokens)
    if rank == 0:
        np.savez(os.path.join(out, "rank0.npz"), **arrays)
    mv.shutdown()
    return res


#: The pipeline test's stage: a tanh layer with a bias; its loss a sum of
#: squares against the targets through a head matrix.
PIPE_MB, PIPE_DIM, PIPE_M = 3, 8, 5


def pipe_inputs(S: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(S, PIPE_DIM, PIPE_DIM)).astype(np.float32)
            * 0.5,
            "b": rng.normal(size=(S, PIPE_DIM)).astype(np.float32) * 0.1,
            "head": rng.normal(size=(PIPE_DIM, 2)).astype(np.float32),
            "xs": rng.normal(size=(PIPE_M, PIPE_MB, PIPE_DIM))
            .astype(np.float32),
            "tgts": rng.normal(size=(PIPE_M, PIPE_MB, 2)).astype(np.float32)}


def case_pipe(rank: int, out: str, n: str, coordinator: str) -> dict:
    """pipeline_train_1f1b and pipeline_apply over a stage axis of n ranks
    (pipe_inputs' stage and loss); each rank writes its stage's
    gradients, the head's and the input's."""
    import torch
    n = int(n)
    mv, mesh = _world(rank, n, coordinator, f"stage:{n}")
    from multiverso_tpu_torch.parallel import pipeline as pp
    s = mesh.axis_index("stage")
    ins = {k: torch.as_tensor(v) for k, v in pipe_inputs(n).items()}
    stage = {"w": ins["w"][s].clone().requires_grad_(True),
             "b": ins["b"][s].clone().requires_grad_(True)}
    head = {"head": ins["head"].clone().requires_grad_(True)}

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def loss_fn(h, y, t):
        return ((y @ h["head"] - t) ** 2).sum()

    loss, sg, hg, dx = pp.pipeline_train_1f1b(
        stage_fn, loss_fn, stage, ins["xs"], ins["tgts"], mesh,
        head_params=head, return_input_grads=True)
    ys = pp.pipeline_apply(stage_fn, stage, ins["xs"], mesh)
    np.savez(os.path.join(out, f"rank{rank}.npz"), w=sg["w"].numpy(),
             b=sg["b"].numpy(), head=hg["head"].numpy(), dx=dx.numpy(),
             ys=ys.detach().numpy())
    mv.shutdown()
    return {"rank": rank, "stage": s, "loss": float(loss)}


CASES = {"world": case_world, "machine_file": case_machine_file,
         "seq_attn": case_seq_attn, "lm": case_lm, "pipe": case_pipe}


def main() -> int:
    case, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    res = CASES[case](rank, out, *sys.argv[4:])
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
