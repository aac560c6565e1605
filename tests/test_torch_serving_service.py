"""The port's serving plane end to end on localhost: ``ServingService``
with ``ServingClient`` over the DCN framing (``multiverso_tpu_torch/
serving/service.py``, ``client.py``, ``parallel/net.py``).

LM requests over the wire return the JAX package's drain tokens (its
``AttentionLMRunner.run`` on the same prompt alone, equal), in continuous
paged mode and in the two drain modes; several requests are in flight on
one connection; a shed reaches the client as an error. Every service and
client is closed by the test, which joins their threads with a timeout.
"""

import threading

import numpy as np
import pytest

import _torch_port
import _torch_serving as ts

torch = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch
    torch = _torch_port.load_torch()


@pytest.fixture(scope="module")
def params():
    return ts.jax_params()


@pytest.fixture(scope="module")
def want(params):
    """The JAX drain runner's tokens for a prompt alone (max_new 4)."""
    runner = ts.jax_runner(params, max_new=4, max_batch=3)
    memo = {}

    def solo(prompt, bucket=8):
        key = (tuple(prompt), bucket)
        if key not in memo:
            memo[key] = ts.solo(runner, prompt, bucket)
        return memo[key]
    return solo


@pytest.fixture
def plane():
    """(service, client factory); both closed after the test."""
    from multiverso_tpu_torch.serving import ServingClient, ServingService
    from multiverso_tpu_torch.telemetry import reset_telemetry

    reset_telemetry()
    svc = ServingService()
    clients = []

    def client():
        clients.append(ServingClient(*svc.address))
        return clients[-1]

    yield svc, client
    for c in clients:
        c.close()
        assert not c._reader.is_alive()
    svc.close()
    assert not svc._accept_thread.is_alive()


MODES = {"continuous paged": dict(continuous=True, paged=True, kv_page=4),
         "continuous preallocated": dict(continuous=True),
         "drain preallocated": dict(pipeline_depth="auto"),
         "drain paged": dict(pipeline_depth=2)}


@pytest.mark.parametrize("mode", list(MODES))
def test_lm_over_the_wire_returns_drain_tokens(params, want, plane, mode):
    svc, client = plane
    kw = dict(MODES[mode])
    runner_kw = dict(paged=True, page=4) if mode == "drain paged" else {}
    runner = ts.port_runner(params, max_new=4, max_batch=3, **runner_kw)
    svc.register_runner(runner, buckets=(8, 16), max_batch=3,
                        max_wait_ms=1.0, **kw)
    assert svc.warmup() >= 2
    cli = client()
    for prompt in ([5, 9, 2], [1], [7, 3, 3, 3, 8, 2, 40],
                   list(range(1, 13))):
        bucket = 8 if len(prompt) <= 8 else 16
        got = cli.generate(np.asarray(prompt, np.int32), deadline_ms=60_000,
                           timeout=120)
        assert got.dtype == np.int32
        assert got.tolist() == want(prompt, bucket), (mode, prompt)
    if mode.startswith("drain"):
        assert svc.batcher(0).pipeline_depth >= 2


def test_many_requests_in_flight_on_one_connection(params, want, plane):
    """One client socket, several threads: replies route by msg_id even
    when they complete out of order."""
    svc, client = plane
    runner = ts.port_runner(params, max_new=4, max_batch=3)
    svc.register_runner(runner, buckets=(8,), max_batch=3, continuous=True,
                        paged=True, kv_page=4)
    cli = client()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 60, int(n)).tolist()
               for n in rng.integers(1, 9, 12)]
    expected = [want(p) for p in prompts]
    errors = []

    def hit(idx):
        for i in idx:
            got = cli.generate(np.asarray(prompts[i], np.int32),
                               deadline_ms=60_000, timeout=120)
            if got.tolist() != expected[i]:
                errors.append((prompts[i], got.tolist()))

    threads = [threading.Thread(target=hit, args=(range(k, 12, 4),))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors[:2]
    futs = [cli.request_async(np.asarray(p, np.int32), 60_000.0)
            for p in prompts[:6]]
    for p, f in zip(prompts[:6], futs):
        values, clock = f.wait(120)
        assert values.tolist() == want(p) and clock == -1


def test_shed_reaches_the_client_as_an_error(params, plane):
    from multiverso_tpu_torch.serving import ShedError

    svc, client = plane
    runner = ts.port_runner(params, max_new=4, max_batch=2)
    svc.register_runner(runner, buckets=(4,), max_batch=2, continuous=True,
                        paged=True, kv_page=4)
    cli = client()
    with pytest.raises(ShedError, match="oversize"):
        cli.generate(np.arange(9, dtype=np.int32) + 1, deadline_ms=10_000)
    with pytest.raises(ShedError, match="deadline"):
        cli.generate(np.asarray([2, 3], np.int32), deadline_ms=0.0)
    with pytest.raises(ShedError, match="no runner 7"):
        cli.generate(np.asarray([2], np.int32), runner_id=7)


def test_hot_swap_lands_at_the_next_request(params, want, plane):
    svc, client = plane
    runner = ts.port_runner(params, max_new=4, max_batch=2)
    svc.register_runner(runner, buckets=(8,), max_batch=2, continuous=True,
                        paged=True, kv_page=4)
    cli = client()
    prompt = np.asarray([5, 9, 2], np.int32)
    assert cli.generate(prompt, deadline_ms=60_000).tolist() == \
        want([5, 9, 2])
    new = ts.jax_params(key=9)
    runner.swap_params(new)
    assert svc.quiesce(timeout_s=30)
    want2 = ts.solo(ts.jax_runner(new, max_new=4, max_batch=2), [5, 9, 2], 8)
    assert want2 != want([5, 9, 2])
    assert cli.generate(prompt, deadline_ms=60_000).tolist() == want2


def test_serve_config_reads_the_serving_flags():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.apps._runner import serve_config
    from multiverso_tpu_torch.utils.configure import reset_flags
    from multiverso_tpu_torch.utils.log import FatalError

    mv.init(["-platform=cpu", "-serve_continuous=true",
             "-serve_paged_kv=true", "-serve_kv_page=4",
             "-serve_kv_pages=64", "-serve_kv_dtype=BF16",
             "-serve_buckets=8,16", "-serve_pipeline_depth=3"])
    try:
        cfg = serve_config()
        assert cfg["buckets"] == (8, 16) and cfg["continuous"]
        assert cfg["paged"] and cfg["kv_page"] == 4
        assert cfg["kv_pages"] == 64 and cfg["kv_dtype"] == "bf16"
        assert cfg["pipeline_depth"] == "3" and cfg["prefix_entries"] == 0
        mv.set_flag("serve_kv_dtype", "fp4")
        with pytest.raises(FatalError, match="serve_kv_dtype"):
            serve_config()
        mv.set_flag("serve_kv_dtype", "f32")
        mv.set_flag("serve_buckets", "8,x")
        with pytest.raises(FatalError, match="serve_buckets"):
            serve_config()
    finally:
        mv.shutdown()
        reset_flags()


SERVE_FLAGS = ("serve_host", "serve_port", "serve_buckets",
               "serve_max_wait_ms", "serve_max_batch", "serve_admission",
               "serve_wire_dtype", "serve_pipeline_depth",
               "serve_cache_rows", "serve_cache_staleness",
               "serve_cache_mem_budget", "serve_continuous",
               "serve_paged_kv", "serve_kv_page", "serve_kv_pages",
               "serve_kv_dtype", "serve_table_dtype", "serve_prefix_cache",
               "telemetry_sample_rate", "telemetry_slow_ms")


def test_serving_flags_match_the_jax_definitions():
    """Every flag the port's serving slice reads has the JAX package's
    type and default."""
    from multiverso_tpu.utils import configure as jax_cfg
    from multiverso_tpu_torch.utils import configure as cfg

    for name in SERVE_FLAGS:
        mine = cfg._registry._flags[name]
        want = jax_cfg._registry._flags[name]
        assert (mine.type, mine.default) == (want.type, want.default), name


def test_wire_codecs_round_trip():
    from multiverso_tpu_torch.core.actor import Message, MsgType
    from multiverso_tpu_torch.parallel import net
    from multiverso_tpu_torch.telemetry.context import new_root

    vals = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    assert np.array_equal(net.unpack_serve_payload(
        net.pack_serve_payload(vals)), vals)
    half = net.unpack_serve_payload(net.pack_serve_payload(vals, "bf16"))
    assert np.abs(half - vals).max() <= np.abs(vals).max() * 2 ** -8
    toks = np.arange(4, dtype=np.int32)
    assert net.unpack_serve_payload(
        net.pack_serve_payload(toks, "bf16")).dtype == np.int32
    ctx = new_root(sampled=True)
    assert net.unpack_trace_ctx(net.pack_trace_ctx(ctx)) == ctx
    assert net.unpack_trace_ctx(np.zeros(2, np.uint64)) is None
    assert net.unpack_json_blob(net.pack_json_blob({"a": [1]})) == {"a": [1]}
    msg = Message(type=MsgType.Serve_Request, table_id=3, msg_id=7,
                  data=[toks, np.asarray([1.5])])
    frame = net.pack_message(msg)
    got, used = net.parse_frame(frame)
    assert used == len(frame) and got.msg_id == 7 and got.table_id == 3
    assert np.array_equal(got.data[0], toks)
    assert net.parse_frame(frame[:-1]) == (None, 0)
    assert got.create_reply().type == MsgType.Serve_Reply
