#!/usr/bin/env python3
"""Hold versions of the stateful row Add side by side on one card (card
only): trees of the repository (each with its own store, wrappers and
``csrc/stateful_rows.cu``) and variants of this checkout's
``csrc/stateful_rows.cu`` run through this checkout's wrappers.

    python3 scripts/torch_stateful_steps.py [--tree NAME=DIR ...] \\
        [--cu NAME=FILE ...] [--flags NAME=FLAGS ...] [--order NAMES] \\
        [--w2v NAMES] [--out FILE]

``--tree``, ``--cu``, ``--flags`` and ``--order`` as in
``scripts/torch_row_steps.py`` (``scripts/_torch_steps.py`` runs each
version in a process of its own, in turns: ``parent,new,new,parent``).
Each version times, at the table plane's main path (100,000 ids, the
B1/B2 draw, into a 1,000,000 x 50 ``use_pallas`` table of momentum_sgd,
adagrad and ftrl, one worker): the whole row Add through
``ServerStore.apply_rows`` (CUDA events over 3 x 50 calls, and in a CUDA
graph), the kernel alone (the fused route after its sort where the tree
has it, else B3 on the combined lanes), and the combine's fold on the
sorted deltas. The versions named in ``--w2v`` also train one block each
of word2vec's plain-step paths (sg-hs, cbow-ns, cbow-hs and the host
batch path, ``chip_smoke.other_paths``) twice and report words/sec, the
second run warm. One JSON record per version goes to ``--out`` and every
line is printed with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_steps as steps  # noqa: E402

ENTRIES = ("mv_fused_stateful_rows", "mv_fused_stateful_sorted_rows",
           "mv_fused_stateful_sorted_rows_i64", "mv_fold_sorted_runs_f32",
           "mv_fold_sorted_runs_f64")
# The main path's instances (int32 keys, D = 50: float2, 8 lanes a row).
MAIN = tuple(f"stateful_runs_kernelILi{k}ELi2ELi8EiEE" for k in range(3)) + (
    "fold_runs_kernelIfLi2ELi8EE",)


def child(tree: str, cu: str, flags: str, w2v: bool) -> dict:
    """One version's readings, in this process."""
    rows = steps.import_from(tree, "ops.rows")
    table = steps.import_from(tree, "core.table")
    upd = steps.import_from(tree, "core.updater")
    options = steps.import_from(tree, "core.options")
    import chip_smoke as cs        # this checkout's inputs and timers
    import numpy as np
    import torch
    if cu:
        steps.use_library(rows, steps.variant_library("stateful_rows", cu,
                                                      flags),
                          ENTRIES, lib_attr="_stateful_lib")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    torch.randn((cs.ROWS, cs.COLS), generator=g, device=dev)
    ids = torch.randint(0, cs.ROWS, (cs.N_IDS,), generator=g, device=dev,
                        dtype=torch.int32).to(torch.int64)
    deltas = torch.randn((cs.N_IDS, cs.COLS), generator=g, device=dev)
    opt = options.AddOption(**cs.STATEFUL_OPT)
    out = {"fused_route": hasattr(rows, "fused_stateful_sorted_rows")}
    for name in cs.STATEFUL:
        store = table.ServerStore(f"steps_{name}", (cs.ROWS, cs.COLS),
                                  np.float32,
                                  upd.get_updater(np.float32, name), dev,
                                  num_workers=1, use_pallas_rows=True)

        def add():
            store.apply_rows(ids, deltas, opt)

        if out["fused_route"]:
            sort = rows.sort_rows(ids, cs.ROWS)

            def kernel():
                rows.fused_stateful_sorted_rows(store.data, store.state, ids,
                                                deltas, opt.scalars(),
                                                store.updater, sort=sort)
        else:
            r, d = upd.combine_duplicate_rows(ids, deltas, cs.ROWS)
            r32 = r.to(torch.int32)

            def kernel():
                rows.fused_stateful_rows(store.data, store.state, r32, d,
                                         opt.scalars(), store.updater)

        out[name] = {
            "add_ms": cs.repeat_ms({"add": add}, readings=3, calls=50)["add"],
            "add_graph_ms": cs.graph_ms(add),
            "kernel_ms": cs.cuda_ms(kernel, 50),
            "kernel_graph_ms": cs.graph_ms(kernel)}
        del store
    sorted_ids, order = torch.sort(ids, stable=True)
    sd = deltas.index_select(0, order)

    def fold():
        rows.fold_sorted_runs(sorted_ids, sd)

    out["fold"] = {"ms": cs.cuda_ms(fold, 50), "graph_ms": cs.graph_ms(fold)}
    if w2v:
        import multiverso_tpu_torch as mv
        d, sents = cs.zipf_corpus(cs.V, 512, 500)
        mv.init([])
        out["w2v"] = [{name: st["words_per_sec"] for name, st in
                       cs.other_paths(sents, d).items()} for _ in range(2)]
        mv.shutdown()
    return out


def report(rec: dict) -> None:
    import chip_smoke as cs
    name, card = rec["version"], rec["card"]
    for upd in cs.STATEFUL:
        r = rec[upd]
        what = "fused route" if rec["fused_route"] else "B3 (combined)"
        print(f"{name} {upd}: whole Add {cs.spread(r['add_ms'])} ms "
              f"(graph {r['add_graph_ms']:.4f}); {what} kernel "
              f"{r['kernel_ms']:.4f} ms (graph {r['kernel_graph_ms']:.4f}) "
              f"[{card}]", flush=True)
    print(f"{name} fold_sorted_runs: {rec['fold']['ms']:.4f} ms (graph "
          f"{rec['fold']['graph_ms']:.4f}) [{card}]", flush=True)
    for k, run in enumerate(rec.get("w2v", [])):
        print(f"{name} word2vec plain steps, run {k + 1}: " + ", ".join(
            f"{leg} {wps:.6g} words/sec" for leg, wps in run.items())
            + f" [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    steps.add_arguments(ap)
    ap.add_argument("--w2v", default="",
                    help="comma-separated versions that also train the "
                         "word2vec plain-step paths")
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(*steps.child_spec(args), args.w2v == "1")))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_stateful_steps: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, steps.REPO)
    import chip_smoke as cs
    variants = [(cu, flags) for _, cu, flags in steps.versions(args).values()
                if cu]
    for (cu, flags), log in steps.build_variants("stateful_rows",
                                                 variants).items():
        for kernel, line in cs.ptxas_lines(log):
            if kernel in MAIN:
                print(f"  {os.path.basename(cu)} {flags}: {kernel}: {line}")
    w2v = set(filter(None, args.w2v.split(",")))
    steps.run(__file__, args, timeout=900, on_record=report,
              child_args=lambda name: ["--w2v=" + ("1" if name in w2v
                                                   else "0")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
