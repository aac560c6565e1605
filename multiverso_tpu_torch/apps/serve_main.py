"""Serving CLI: stand up a dynamic-batching lookup service over a
checkpoint replica (port of ``multiverso_tpu/apps/serve_main.py``).

The deployment shape is the checkpoint-to-replica handoff: training
emits checkpoints, this process follows the checkpoint directory with a
frozen read-only replica on the card and serves batched row lookups over
the DCN framing, with no coordination channel to the trainer beyond the
filesystem. ``-serve_device=cpu`` serves from the host CPU (it selects
``-platform=cpu``); without it and without a card the process exits 1.

    python -m multiverso_tpu_torch.apps.serve_main \\
        -checkpoint_dir=/ckpts -serve_table=matrix_0 \\
        -serve_port=7070 -serve_buckets=8,16,32,64 -serve_max_wait_ms=2

Flags: ``-checkpoint_dir``, ``-serve_table``, ``-serve_refresh_s``,
``-serve_duration``, ``-serve_addr_file``, ``-serve_table_dtype``
(f32|bf16|int8 replica storage), ``-serve_device``, and the
``-serve_*`` batcher and cache flags (``-serve_port``,
``-serve_buckets``, ``-serve_max_wait_ms``, ``-serve_max_batch``,
``-serve_admission``, ``-serve_wire_dtype``, ``-serve_cache_rows``,
``-serve_cache_staleness``).
"""

from __future__ import annotations

import os
import sys
import time
from typing import List

from multiverso_tpu_torch.apps._runner import (pin_device_if_requested,
                                               run_app, serve_config)
from multiverso_tpu_torch.utils.configure import (define_double,
                                                  define_string, get_flag)
from multiverso_tpu_torch.utils.log import check, log

define_string("checkpoint_dir", "", "checkpoint directory to serve from "
              "(latest complete ckpt_* is loaded and followed)")
define_string("serve_table", "", "table name to serve rows from (empty = "
              "the checkpoint's first table)")
define_string("serve_device", "default", "default|cpu: the card unless "
              "-serve_device=cpu")
define_double("serve_refresh_s", 5.0, "seconds between checkpoint "
              "refresh polls (hot-swap cadence)")


def _body(remaining: List[str]) -> int:
    del remaining
    from multiverso_tpu_torch.serving import (CheckpointReplica,
                                              ReplicaLookupRunner,
                                              ServingService,
                                              cache_from_flags)

    ckpt_dir = str(get_flag("checkpoint_dir"))
    check(bool(ckpt_dir), "-checkpoint_dir is required")
    cfg = serve_config()
    replica = CheckpointReplica(ckpt_dir, table_dtype=cfg["table_dtype"])
    snap = replica.snapshot()
    table = str(get_flag("serve_table")) or snap.names[0]
    check(table in snap.names,
          f"-serve_table={table!r} not in checkpoint (has {snap.names})")
    replica.start_auto_refresh(float(get_flag("serve_refresh_s")))

    service = ServingService(host=cfg["host"], port=cfg["port"])
    try:
        service.register_runner(
            ReplicaLookupRunner(replica, table, cache=cache_from_flags()),
            buckets=cfg["buckets"], max_batch=cfg["max_batch"],
            max_wait_ms=cfg["max_wait_ms"], max_queue=cfg["max_queue"],
            pipeline_depth=cfg["pipeline_depth"])
        host, port = service.address
        log.info("serving table '%s' (step %d, %s on %s) at %s:%d", table,
                 snap.step, replica.table_dtype, replica.device, host, port)
        addr_file = str(get_flag("serve_addr_file"))
        if addr_file:
            with open(addr_file + ".tmp", "w") as f:
                f.write(f"{host}:{port}")
            os.replace(addr_file + ".tmp", addr_file)

        duration = float(get_flag("serve_duration"))
        deadline = time.monotonic() + duration if duration > 0 else None
        try:
            while deadline is None or time.monotonic() < deadline:
                # Parks the main thread while the service threads serve;
                # 0.2 s bounds Ctrl-C latency.
                time.sleep(0.2)
        except KeyboardInterrupt:
            log.info("serve_main: interrupted, shutting down")
    finally:
        service.close()
        replica.close()
    return 0


def main(argv=None) -> int:
    # Serving processes convoy on the default 5 ms GIL switch interval;
    # 0.5 ms keeps request latency off that floor.
    sys.setswitchinterval(5e-4)
    args = list(argv if argv is not None else sys.argv[1:])
    pin_device_if_requested(args, "serve_device")
    return run_app(_body, args)


if __name__ == "__main__":
    sys.exit(main())
