#!/usr/bin/env python3
"""Hold versions of the sorted scatter-adds B2 and B4 side by side on one
card (card only): trees of the repository (each with its own wrapper,
``ops/rows.py``, and kernel source, ``csrc/rows.cu``) and kernel sources
run through this checkout's wrapper.

    python3 scripts/torch_row_steps.py [--tree NAME=DIR ...] \\
        [--cu NAME=FILE ...] [--flags NAME=FLAGS ...] [--order NAMES] \\
        [--out FILE]

``--tree`` takes a checkout of the repository (for example the parent
commit unpacked by ``git archive`` into ``build/``); ``--cu`` a variant of
``csrc/rows.cu`` with this checkout's C interface, built with the port's
own ``nvcc`` flags. With neither, the checkout itself is timed. Each
version runs in a process of its own, in the order given by ``--order``
(comma-separated names, repeats allowed: ``parent,new,new,parent``;
``scripts/_torch_steps.py`` runs them), at the main path's shapes: B2 with 100,000 int64 sorted ids into 1,000,000
x 50 (the table plane's Add), B4 with 8,192 int64 sorted ids into 100,000
x 128 (``bench.py``'s leg). Each reading holds the version against the
plain version on the card (bitwise, both signs), then times, per call:
CUDA events over 200 back-to-back wrapper calls, 5 readings, the wrapper
and ``index_add_`` in turns; the wrapper in a CUDA graph (device time, no
host cost); and the host's time to issue one call (the host clock over
200 calls before any synchronize; at B2's shape, where the card is the
slower side, this includes waits on its queue), beside the same for the
C entry point called directly with its arguments made beforehand
(ctypes and the launch: the rest is the wrapper's Python). One JSON
record per reading goes to ``--out`` and every line is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_steps as steps  # noqa: E402

# The main paths' instances: B2 at D = 50 (float2, 8 lanes a row, int64
# ids) and B4 at D = 128 (float4).
MAIN = ("scatter_runs_kernelILi0ELi2ELi8ElEE",
        "scatter_runs_kernelILi1ELi4ELi8ElEE")


def host_ms(fn, calls: int = 200, readings: int = 5) -> float:
    """Median host time to issue one call of ``fn`` (no synchronize while
    the calls are issued). Where the card takes longer per call than the
    host, its launch queue pushes back and the reading includes the wait:
    it is the host's cost only where the card is the faster side."""
    import torch
    got = []
    for _ in range(readings):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        got.append((time.perf_counter() - t0) / calls * 1e3)
        torch.cuda.synchronize()
    return statistics.median(got)


def child(tree: str, cu: str, flags: str) -> dict:
    """One version's readings, in this process."""
    rows = steps.import_from(tree, "ops.rows")
    _build = steps.import_from(tree, "ops._build")
    import chip_smoke as cs        # this checkout's timing helpers
    import torch
    if cu:
        steps.use_library(rows, steps.variant_library("rows", cu, flags),
                          list(rows._SCATTER.values()),
                          keep=("mv_gather_rows",))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for kernel, (n_rows, cols, n) in (
            ("scatter_add_sorted_rows", (cs.ROWS, cs.COLS, cs.N_IDS)),
            ("tiled_scatter_add_sorted_rows",
             (cs.B4_ROWS, cs.B4_COLS, cs.B4_IDS))):
        fn = getattr(rows, kernel)
        table = torch.randn((n_rows, cols), generator=g, device=dev)
        ids = torch.sort(torch.randint(0, n_rows, (n,), generator=g,
                                       device=dev))[0]
        deltas = torch.randn((n, cols), generator=g, device=dev)
        uniq = int(torch.unique(ids).numel())
        for sign in (1.0, -1.0):
            a, b = table.clone(), table.clone()
            fn(a, ids, deltas, sign)
            getattr(rows, kernel + "_plain")(b, ids, deltas, sign)
            torch.cuda.synchronize()
            assert torch.equal(a, b), (kernel, sign)
        work = table.clone()
        ev = cs.repeat_ms({"kernel": lambda: fn(work, ids, deltas),
                           "index_add_": lambda: work.index_add_(0, ids,
                                                                 deltas)})
        out[kernel] = {
            "ms": ev["kernel"], "index_add_ms": ev["index_add_"],
            "graph_ms": cs.graph_ms(lambda: fn(work, ids, deltas)),
            "index_add_graph_ms": cs.graph_ms(
                lambda: work.index_add_(0, ids, deltas)),
            "host_ms": host_ms(lambda: fn(work, ids, deltas)),
            "index_add_host_ms": host_ms(
                lambda: work.index_add_(0, ids, deltas)),
            "bound_ms": cs.bound_ms(n * 8 + n * cols * 4
                                    + 2 * uniq * cols * 4, n * cols)[0]}
        # The C entry point alone (ctypes and the launch), its arguments
        # made beforehand: the rest of host_ms is the wrapper's Python.
        lib = rows._lib()
        entry = "mv_" + kernel
        sid = ids if hasattr(lib, entry + "_i64") else ids.to(torch.int32)
        c_fn = getattr(lib, entry + ("_i64" if sid is ids else ""))
        args = (work.data_ptr(), sid.data_ptr(), deltas.data_ptr(), n,
                n_rows, cols, 1.0, torch.cuda.current_stream().cuda_stream)
        out[kernel]["entry_host_ms"] = host_ms(lambda: c_fn(*args))
    out["stream_helper_us"] = 1e3 * host_ms(
        lambda: _build.stream(table), calls=1000) if hasattr(
        _build, "stream") else None
    out["current_stream_us"] = 1e3 * host_ms(
        lambda: torch.cuda.current_stream(dev).cuda_stream, calls=1000)
    return out


def report(rec: dict) -> None:
    import chip_smoke as cs
    name, card = rec["version"], rec["card"]
    for kernel in ("scatter_add_sorted_rows",
                   "tiled_scatter_add_sorted_rows"):
        r = rec[kernel]
        print(f"{name} {kernel}: events {cs.spread(r['ms'])} ms "
              f"(index_add_ {cs.spread(r['index_add_ms'])}), graph "
              f"{r['graph_ms']:.4f} (index_add_ "
              f"{r['index_add_graph_ms']:.4f}), host per call "
              f"{r['host_ms'] * 1e3:.2f} us (index_add_ "
              f"{r['index_add_host_ms'] * 1e3:.2f} us; the C entry "
              f"point alone {r['entry_host_ms'] * 1e3:.2f} us), bound "
              f"{r['bound_ms']:.4f} ms [{card}]", flush=True)
    print(f"{name}: stream handle {rec['stream_helper_us']} us per call "
          f"(helper), {rec['current_stream_us']:.3f} us "
          f"(torch.cuda.current_stream)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    steps.add_arguments(ap)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(*steps.child_spec(args))))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_row_steps: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, steps.REPO)
    import chip_smoke as cs
    variants = [(cu, flags) for _, cu, flags in steps.versions(args).values()
                if cu]
    for (cu, _), log in steps.build_variants("rows", variants).items():
        for kernel, line in cs.ptxas_lines(log):
            if "registers" in line and kernel in MAIN:
                print(f"  {os.path.basename(cu)}: {kernel}: {line}")
    steps.run(__file__, args, timeout=600, on_record=report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
