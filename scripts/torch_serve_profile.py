#!/usr/bin/env python3
"""Where a decode step's time goes: the port's continuous paged decode of
the attention LM at GPT-2-small widths, under ``torch.profiler``.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_serve_profile.py [--requests 16]

It builds ``multiverso_tpu_torch``'s ``AttentionLMRunner`` (vocab 50,257,
dim 768, 12 heads, 12 layers; weights from seed 0) behind a paged
``ContinuousBatcher`` (buckets 128 and 512, 8 slots each, pages of 16),
warms it up, then submits ``--requests`` prompts of ``chip_smoke.py``'s
serving workload at once and traces the whole decode. It prints the
wall time, the engine steps, the device time summed over every kernel and
copy (one stream: they do not overlap), the device's busy share of the
wall time, and the kernels that took the most device time, B7
(``paged_decode_kernel``) among them. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=16)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from multiverso_tpu_torch.models.attention_lm import (LMConfig,
                                                          init_params)
    from multiverso_tpu_torch.serving import (AttentionLMRunner,
                                              ContinuousBatcher)
    from multiverso_tpu_torch.telemetry import get_registry

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LMConfig(**cs.LM, seed=0)
    params = {k: v.cpu().numpy() for k, v in init_params(cfg).items()}
    runner = AttentionLMRunner(params, cfg, max_new=cs.SERVE_MAX_NEW,
                               max_batch=cs.SERVE_BATCH)
    cb = ContinuousBatcher(runner, cs.SERVE_BUCKETS,
                           max_batch=cs.SERVE_BATCH, max_queue=256,
                           paged=True, page=cs.SERVE_PAGE)
    try:
        cb.warmup()
        rng = np.random.default_rng(7)
        shared = rng.integers(1, 60, cs.SERVE_BUCKETS[-1] // 3).tolist()
        prompts = cs.decode_workload(rng, args.requests,
                                     cs.SERVE_BUCKETS[-1], 0.5, shared)
        steps = get_registry().counter("serve.continuous.steps")
        s0 = steps.snapshot()["value"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            futs = [cb.submit(np.asarray(p, np.int32), deadline_ms=600_000)
                    for p in prompts]
            for f in futs:
                f.wait(600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n_steps = steps.snapshot()["value"] - s0
    finally:
        cb.close()
    events = prof.key_averages()
    device_us = sum(_device_us(e) for e in events)
    rows = sorted(((_device_us(e), e.count, e.key) for e in events
                   if _device_us(e) > 0), reverse=True)
    card = cs.card_line()
    print(f"continuous paged decode, {len(prompts)} prompts x "
          f"{cs.SERVE_MAX_NEW} tokens, GPT-2-small widths: wall {wall:.4f} s "
          f"under the profiler, {n_steps} engine steps "
          f"({wall / max(n_steps, 1) * 1e3:.3f} ms per step), device time "
          f"{device_us / 1e3:.2f} ms summed over kernels and copies: busy "
          f"{device_us / 1e6 / wall:.1%} of the wall time [{card}]")
    for us, count, key in rows[:12]:
        print(f"  {us / 1e3:10.3f} ms  {count:7d} calls  "
              f"{us / max(count, 1):9.2f} us/call  {key[:90]}")
    b7 = [(us, count) for us, count, key in rows
          if "paged_decode_kernel" in key]
    if b7:
        us = sum(u for u, _ in b7)
        n = sum(c for _, c in b7)
        print(f"B7 paged_decode_kernel: {n} launches, {us / 1e3:.3f} ms, "
              f"{us / n:.2f} us per launch, {us / max(device_us, 1):.1%} of "
              "the device time")
    if device_us == 0:
        print("the profiler recorded no device time")
    return 0


if __name__ == "__main__":
    sys.exit(main())
