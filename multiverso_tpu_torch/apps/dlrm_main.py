"""DLRM online-recommender CLI — the train-while-serve workload (port of
``multiverso_tpu/apps/dlrm_main.py``). Runs on the card unless
``-dlrm_device=cpu`` (or ``-platform=cpu``) is given.

One process drives the whole loop:

    train -> checkpoint -> replica-publish -> serve -> retrain

A DLRM model trains on the synthetic drifting impression stream with its
embedding tables on the PS plane, publishes a full checkpoint every
``-dlrm_publish_every`` steps, and (with ``-dlrm_serve_qps > 0``) a
serving load answers row lookups against the LIVE tables through a
SparseLookupRunner + HotRowCache while training continues. Freshness
lanes score every incoming batch prequentially against progressively
staler published snapshots, so the run's summary carries the
freshness-vs-staleness AUC curve.

Usage:
    python -m multiverso_tpu_torch.apps.dlrm_main -dlrm_steps=400 \
        -dlrm_serve_qps=500 -dlrm_ckpt_dir=/tmp/dlrm_ckpt
"""

from __future__ import annotations

import json
import sys
import tempfile
from typing import List

from multiverso_tpu_torch.utils import configure
from multiverso_tpu_torch.utils.log import log

# Model shape
configure.define_int("dlrm_fields", 4, "categorical feature fields")
configure.define_int("dlrm_vocab", 2048, "ids per field (embedding rows)")
configure.define_int("dlrm_embed_dim", 16, "embedding width")
configure.define_int("dlrm_dense_dim", 8, "continuous features")
configure.define_string("dlrm_bottom_mlp", "32", "bottom MLP widths, comma")
configure.define_string("dlrm_top_mlp", "32", "top MLP widths, comma")
configure.define_double("dlrm_lr", 0.05, "client-side delta prescale")
configure.define_double("dlrm_adagrad_step", 0.05,
                        "server-side adagrad step scale (AddOption.rho)")
configure.define_int("dlrm_seed", 0, "model init seed")
# Stream dynamics
configure.define_double("dlrm_zipf", 1.2, "id skew alpha (<=1 uniform)")
configure.define_int("dlrm_drift_every", 2048,
                     "impressions between click-model drift steps (0=off)")
configure.define_double("dlrm_drift_scale", 0.25, "drift step stddev")
configure.define_int("dlrm_stream_seed", 0, "impression stream seed")
# Online loop
configure.define_int("dlrm_steps", 400, "training steps")
configure.define_int("dlrm_batch", 128, "impressions per step")
configure.define_int("dlrm_publish_every", 40,
                     "steps between checkpoint publishes")
configure.define_int("dlrm_eval_every", 4,
                     "steps between prequential freshness evals")
configure.define_string("dlrm_lanes", "1,4",
                        "staleness lanes (publishes behind), comma")
configure.define_string("dlrm_table_dtype", "f32",
                        "serving-lane table storage dtype (f32|bf16|int8)")
configure.define_string("dlrm_ckpt_dir", "",
                        "checkpoint dir (default: fresh temp dir)")
# Serving plane
configure.define_double("dlrm_serve_qps", 0.0,
                        "offered lookup QPS against the live table (0=off)")
configure.define_int("dlrm_serve_keys", 16, "keys per lookup request")
configure.define_int("dlrm_serve_batch", 8, "requests per serve batch")
configure.define_int("dlrm_cache_rows", 0, "hot-row cache capacity (0=off)")
configure.define_int("dlrm_cache_staleness", 0,
                     "cache staleness bound (clock ticks)")
configure.define_string("dlrm_summary_file", "",
                        "write the run summary JSON here")
configure.define_string("dlrm_device", "",
                        "device (cpu|default): the card unless "
                        "-dlrm_device=cpu")


def _int_tuple(raw: str, flag: str) -> tuple:
    try:
        return tuple(int(p) for p in str(raw).split(",") if p.strip())
    except ValueError:
        from multiverso_tpu_torch.utils.log import FatalError
        raise FatalError(f"bad -{flag} value '{raw}' "
                         "(want comma-separated ints)") from None


def _body(argv: List[str]) -> int:
    del argv
    from multiverso_tpu_torch.models.dlrm import (DLRMConfig, DLRMModel,
                                                  ImpressionStream,
                                                  StreamConfig)
    from multiverso_tpu_torch.recsys import (OnlineConfig, OnlineLoop,
                                             ServeLoad, make_live_runner)
    from multiverso_tpu_torch.utils.dashboard import Dashboard

    get = configure.get_flag
    cfg = DLRMConfig(
        fields=int(get("dlrm_fields")), vocab=int(get("dlrm_vocab")),
        embed_dim=int(get("dlrm_embed_dim")),
        dense_dim=int(get("dlrm_dense_dim")),
        bottom_mlp=_int_tuple(get("dlrm_bottom_mlp"), "dlrm_bottom_mlp"),
        top_mlp=_int_tuple(get("dlrm_top_mlp"), "dlrm_top_mlp"),
        learning_rate=float(get("dlrm_lr")),
        adagrad_step=float(get("dlrm_adagrad_step")),
        seed=int(get("dlrm_seed")))
    scfg = StreamConfig(
        fields=cfg.fields, vocab=cfg.vocab, dense_dim=cfg.dense_dim,
        zipf=float(get("dlrm_zipf")),
        drift_every=int(get("dlrm_drift_every")),
        drift_scale=float(get("dlrm_drift_scale")),
        seed=int(get("dlrm_stream_seed")))
    ocfg = OnlineConfig(
        steps=int(get("dlrm_steps")), batch=int(get("dlrm_batch")),
        publish_every=int(get("dlrm_publish_every")),
        eval_every=int(get("dlrm_eval_every")),
        lanes=_int_tuple(get("dlrm_lanes"), "dlrm_lanes") or (1,),
        table_dtype=str(get("dlrm_table_dtype")) or "f32")

    ckpt_dir = str(get("dlrm_ckpt_dir"))
    tmp = None
    if not ckpt_dir:
        tmp = tempfile.TemporaryDirectory(prefix="dlrm_ckpt_")
        ckpt_dir = tmp.name
    try:
        model = DLRMModel(cfg, mode="ps")
        stream = ImpressionStream(scfg)
        loop = OnlineLoop(model, stream, ckpt_dir, ocfg)

        qps = float(get("dlrm_serve_qps"))
        load = None
        if qps > 0.0:
            runner = make_live_runner(
                model, field=0, cache_rows=int(get("dlrm_cache_rows")),
                cache_staleness=int(get("dlrm_cache_staleness")))
            load = ServeLoad(runner, vocab=cfg.vocab,
                             zipf=float(get("dlrm_zipf")), qps=qps,
                             keys_per_req=int(get("dlrm_serve_keys")),
                             max_batch=int(get("dlrm_serve_batch")))
            load.start()
        try:
            summary = loop.run()
        finally:
            if load is not None:
                summary_serve = load.stop()
                summary["serve"] = summary_serve
        log.info("dlrm: %d steps, %.1f updates/s, train AUC %.4f",
                 summary["steps"], summary["updates_per_sec"],
                 summary["train_auc"])
        for lane in summary["freshness"]:
            log.info("dlrm freshness: lane=%s auc=%s n=%d", lane["lane"],
                     lane["auc"], lane["n"])
        if load is not None:
            log.info("dlrm serve: offered %.1f QPS achieved %.1f, "
                     "%d lookups, %d errors",
                     summary["serve"]["offered_qps"],
                     summary["serve"]["achieved_qps"],
                     summary["serve"]["requests"],
                     summary["serve"]["errors"])
        out = str(get("dlrm_summary_file"))
        if out:
            with open(out, "w") as f:
                json.dump(summary, f, indent=1, default=float)
            log.info("dlrm: summary -> %s", out)
    finally:
        if tmp is not None:
            tmp.cleanup()
    Dashboard.display(echo=True)
    return 0


def main(argv=None) -> int:
    from multiverso_tpu_torch.apps._runner import (pin_device_if_requested,
                                                   run_app)

    args = argv if argv is not None else sys.argv[1:]
    pin_device_if_requested(args, device_flag="dlrm_device")
    return run_app(_body, args)


if __name__ == "__main__":
    sys.exit(main())
