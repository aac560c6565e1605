#!/usr/bin/env python3
"""Hold versions of the paged decode kernel B7 side by side on one card
(card only): trees of the repository (each with its own wrapper,
``ops/attention.py``, and kernel source, ``csrc/paged_attention.cu``) and
variants of this checkout's kernel source run through this checkout's
wrapper (``scripts/_torch_steps.py`` says how versions are named, built
and ordered).

    python3 scripts/torch_paged_steps.py [--tree NAME=DIR ...] \\
        [--cu NAME=FILE ...] [--flags NAME=FLAGS ...] [--order NAMES] \\
        [--splits N,N,...] [--reps N] [--dh N,N,...] [--phases] \\
        [--out FILE]

Each version runs, in a process of its own, at B7's two main-path shapes
of ``chip_smoke.paged_shapes`` (the serving shape, G 36, and the
long-context shape, G 132, one layer of a 12-layer pool each), with
float32, bfloat16 and int8 pages (int8 with its scale planes, as the
serving codec encodes them). At each it holds the kernel against the
plain version (``PAGED_TOL``), and again with NaN in every page the mask
wholly excludes (int8: payloads of 127 and NaN scales; the plain version
on clean pages; a kernel that reads those pages reports NaN here, it is
not stopped), checks that two launches are bitwise equal and that a
launch replayed from a CUDA graph equals an eager one, then times, in
turns, the kernel, the plain version and (float32) the SDPA yardstick by
CUDA events over ``--reps`` back-to-back calls (5 readings: median and
range), and the kernel (and the yardstick) in a CUDA graph, beside the
byte bound and the splits a slot and head the version's wrapper chose.
``--dh`` adds wider heads (B7's wide instances past 256): the serving
shape at each width listed, the long-context shape at the first, with
the same three page types and the same readings. At a
small shape (4 slots, 4 heads, dh 64, G 12), where the card is the faster
side, it reads the host's time to issue one wrapper call (the host clock
over 200 calls before any synchronize), and the time to read the current
stream's handle through ``torch.cuda.current_stream`` and through
``ops/_build.py::stream``. It also holds the kernel on the small cases
of ``chip_smoke.py``'s B7 check (one per template instance). With
``--splits``, a version whose wrapper has ``paged_splits`` is also timed
at each main-path shape with that many CTAs a slot and head.

``--phases`` then builds this checkout's ``csrc/paged_attention.cu`` with
``-DMV_PAGED_PROFILE`` (thread 0 of each CTA stores ``%globaltimer`` at
its start, after its start-up loads, after its pages and at its exit)
and, after a few launches at each main-path shape (float32 and int8
pages; with ``--dh`` also at the wider heads, as above), prints per slot
the
CTAs' start-up, pages (median and most) and merge-or-exit times and when
its last CTA ended, from the launch's first CTA start. Every line is
printed with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_steps as steps  # noqa: E402

ENTRY = "mv_paged_decode_attn"
PROFILE = "-DMV_PAGED_PROFILE"          # csrc/paged_attention.cu's marks
# The serving shape's instances (dh 64): float32 (16-byte vectors, 8
# lanes a key row, 2 vectors a lane), bfloat16 (8 lanes, 1 vector) and
# int8 (4 lanes, 1 vector), and the PR 5 kernel's (2 columns a lane).
MAIN = ("paged_decode_kernelIfLi4ELi8ELi2EE",
        "paged_decode_kernelI13__nv_bfloat16Li8ELi8ELi1EE",
        "paged_decode_kernelIaLi16ELi4ELi1EE", "paged_decode_kernelIfLi2EE")
# The wide instances (dh 257-512), the column-chunked one and its
# predecessor, by the start of their labels.
WIDE = ("paged_wide_kernel", "paged_decode_chunked_kernel",
        "paged_decode_wide_kernel")


def shown(kernel: str) -> bool:
    """Whether a kernel's registers and spills are printed."""
    return kernel in MAIN or kernel.startswith(WIDE)
#: The page types timed at each main-path shape.
KINDS = ("float32", "bfloat16", "int8")


def host_ms(fn, calls: int = 200, readings: int = 5) -> float:
    """Median host time to issue one call of ``fn``, no synchronize while
    the calls are issued (the host's cost where the card is faster)."""
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


def within(got, want) -> dict:
    import chip_smoke as cs
    import torch
    torch.cuda.synchronize()
    diff = (got - want).abs()
    return {"max_abs_err": float(diff.max()),
            "ok": bool(torch.isfinite(got).all()) and bool(
                (diff <= cs.PAGED_TOL["atol"]
                 + cs.PAGED_TOL["rtol"] * want.abs()).all())}


def repeatable(attention, args, kw) -> dict:
    import torch
    first = attention.paged_decode_attn(*args, **kw)
    second = attention.paged_decode_attn(*args, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        attention.paged_decode_attn(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = attention.paged_decode_attn(*args, **kw)
    graph.replay()
    torch.cuda.synchronize()
    return {"bitwise_repeat": bool(torch.equal(first, second)),
            "graph_equals_eager": bool(torch.equal(captured, first))}


def shape(attention, args, sc, bucket, P, reps, splits, sms) -> dict:
    """One version's readings at one shape and page type (``sc`` the
    int8 pages' scale planes, else empty)."""
    import chip_smoke as cs
    import torch
    kw = dict(bucket=bucket, page=P, scale=args[0].shape[2] ** -0.5, **sc)
    kern = lambda: attention.paged_decode_attn(*args, **kw)  # noqa
    want = attention.paged_decode_attn_plain(*args, **kw)
    rec = {"check": within(kern(), want)}
    if sc:
        poisoned, _, bad = cs.paged_poisoned(args, bucket, P, sc)
    else:
        (poisoned, _), bad = cs.paged_poisoned(args, bucket, P), {}
    rec["nan_excluded_pages"] = within(
        attention.paged_decode_attn(*poisoned, **{**kw, **bad}), want)
    del poisoned, bad, want
    rec.update(repeatable(attention, args, kw))
    fns = {"kernel": kern,
           "plain": lambda: attention.paged_decode_attn_plain(*args, **kw)}
    if not sc and args[1].dtype == torch.float32:
        fns["yardstick"] = cs.paged_yardstick(args, bucket, P)
    ev = cs.repeat_ms(fns, readings=5, calls=reps)
    rec.update({"ms": ev["kernel"], "plain_ms": ev["plain"],
                "graph_ms": cs.graph_ms(kern)})
    if "yardstick" in fns:
        rec.update({"yardstick_ms": ev["yardstick"],
                    "yardstick_graph_ms": cs.graph_ms(fns["yardstick"])})
    q, kp, vp, ptab, lens, ts = args
    rec["bound_ms"], rec["bound_by"] = cs.paged_bound(
        q, kp, ptab, lens, ts, bucket, P)
    G = ptab.shape[1]
    rec["launch_splits"] = (
        attention.paged_launch_splits(q, kp, G, P, sms)
        if hasattr(attention, "paged_launch_splits")
        else attention.paged_splits(q.shape[0] * q.shape[1], G, sms))
    if splits and hasattr(attention, "paged_splits"):
        real = attention.paged_splits
        rec["splits"] = {}
        for n in splits:
            attention.paged_splits = lambda bh, g, sms, n=n: min(g, n)
            rec["splits"][n] = {
                "check": within(kern(), attention.paged_decode_attn_plain(
                    *args, **kw)),
                "ms": cs.repeat_ms({"k": kern}, readings=3, calls=reps)["k"],
                "graph_ms": cs.graph_ms(kern)}
        attention.paged_splits = real
    return rec


def child(tree: str, cu: str, flags: str, reps: int, splits,
          dhs=()) -> dict:
    """One version's readings, in this process."""
    attention = steps.import_from(tree, "ops.attention")
    _build = steps.import_from(tree, "ops._build")
    import chip_smoke as cs
    import torch
    if cu:
        steps.use_library(attention, steps.variant_library(
            "paged_attention", cu, flags), [ENTRY], "_paged_lib")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    P = cs.SERVE_PAGE
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"shapes": {}}
    for kind in KINDS:
        sc = {}
        dtype = None if kind == "float32" else getattr(torch, kind)
        for dh in (None, *dhs):
            for what, bucket, args in cs.paged_shapes(dev, dtype, sc, dh=dh):
                if dh and dh != dhs[0] and "long-context" in what:
                    sc.clear()
                    continue
                key = f"{kind} {what}" + (f", dh {dh}" if dh else "")
                out["shapes"][key] = shape(attention, args, sc, bucket, P,
                                           reps, splits, sms)
                del args
                sc.clear()
                torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(11)
    small = cs.paged_inputs(g, dev, [3, 60, 128, 17], [0, 5, 63, 20], 128,
                            64, 16, 4, 64, 64)
    kw = dict(bucket=128, page=16, scale=0.125)
    out["host_ms"] = host_ms(lambda: attention.paged_decode_attn(*small,
                                                                  **kw))
    out["current_stream_us"] = 1e3 * host_ms(
        lambda: torch.cuda.current_stream(dev).cuda_stream, calls=1000)
    out["stream_helper_us"] = 1e3 * host_ms(
        lambda: _build.stream(small[0]), calls=1000)
    out["instances"] = {}
    for d, dt in cs.PAGED_INSTANCES:
        a = cs.paged_inputs(g, dev, [3, 60, 128, 17], [0, 5, 63, 20], 128,
                            64, 16, 4, d, 64, dtype=getattr(torch, dt))
        kw = dict(bucket=128, page=16, scale=d ** -0.5)
        out["instances"][f"dh {d} {dt}"] = within(
            attention.paged_decode_attn(*a, **kw),
            attention.paged_decode_attn_plain(*a, **kw))
    if not cu:
        out["ptxas"] = [f"{k}: {line}" for k, line in cs.ptxas_lines(
            _build.build_log("paged_attention")) if shown(k)]
    return out


def phases(dhs=()) -> dict:
    """Per-CTA phase times of this checkout's kernel built with its marks,
    at each main-path shape (and the wider heads ``dhs``), summarised per
    slot, in this process."""
    import ctypes
    import numpy as np
    import torch
    attention = steps.import_from(steps.REPO, "ops.attention")
    import chip_smoke as cs
    src = os.path.join(steps.CSRC, "paged_attention.cu")
    lib = steps.use_library(attention, steps.variant_library(
        "paged_attention", src, PROFILE), [ENTRY], "_paged_lib")
    lib.mv_paged_decode_attn_profile.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int]
    lib.mv_paged_decode_attn_profile.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}

    def shapes():
        for dh in (None, *dhs):
            for kind in ("float32", "int8"):
                sc = {}
                dtype = torch.int8 if kind == "int8" else None
                for w, b, a in cs.paged_shapes(dev, dtype, sc, dh=dh):
                    if dh and dh != dhs[0] and "long-context" in w:
                        sc.clear()
                        continue
                    yield (f"{kind} {w}" + (f", dh {dh}" if dh else ""), b,
                           a, dict(sc))
                    sc.clear()

    for what, bucket, args, scales in shapes():
        kw = dict(bucket=bucket, page=cs.SERVE_PAGE,
                  scale=args[0].shape[2] ** -0.5, **scales)
        for _ in range(5):
            attention.paged_decode_attn(*args, **kw)
        torch.cuda.synchronize()
        B, H = args[0].shape[:2]
        G = args[3].shape[1]
        S = attention.paged_launch_splits(args[0], args[1], G, cs.SERVE_PAGE,
                                          sms)
        n = B * H * S
        buf = (ctypes.c_ulonglong * (4 * n))()
        if lib.mv_paged_decode_attn_profile(buf, n) != 0:
            raise RuntimeError("reading the phase marks failed")
        t = np.frombuffer(buf, dtype=np.uint64).reshape(n, 4).astype(
            np.int64)
        t = (t - t[:, 0].min()) / 1e3
        live = attention.paged_live_pages(
            args[4], args[5], bucket=bucket, page=cs.SERVE_PAGE,
            n_pages=G).sum(1).tolist()
        rows = []
        for b in range(B):
            c = t[b * H * S:(b + 1) * H * S]
            rows.append({"live_pages": live[b],
                         "start_up_us": float(np.median(c[:, 1] - c[:, 0])),
                         "pages_us": float(np.median(c[:, 2] - c[:, 1])),
                         "pages_most_us": float(np.max(c[:, 2] - c[:, 1])),
                         "after_pages_most_us": float(
                             np.max(c[:, 3] - c[:, 2])),
                         "end_us": float(c[:, 3].max())})
        out[what] = {"ctas": n, "splits": S, "span_us": float(t[:, 3].max()),
                     "slots": rows}
        print(f"phases {what}: {n} CTAs ({S} a slot and head), the launch "
              f"spans {t[:, 3].max():.2f} us from its first CTA's start "
              f"[{card}]", flush=True)
        for b, r in enumerate(rows):
            print(f"   slot {b}, {r['live_pages']} live pages: start-up "
                  f"{r['start_up_us']:.2f} us, pages {r['pages_us']:.2f} "
                  f"(most {r['pages_most_us']:.2f}), after its pages at "
                  f"most {r['after_pages_most_us']:.2f} (the merge), last "
                  f"CTA ended at {r['end_us']:.2f} us", flush=True)
    return {"version": "phases", "card": card, "phases": out}


def report(rec: dict) -> None:
    import chip_smoke as cs
    name, card = rec["version"], rec["card"]
    for what, r in rec["shapes"].items():
        yard = (f"SDPA yardstick {cs.spread(r['yardstick_ms'])} (graph "
                f"{r['yardstick_graph_ms']:.4f}); "
                if "yardstick_ms" in r else "")
        print(f"{name} {what}: events {cs.spread(r['ms'])} ms, graph "
              f"{r['graph_ms']:.4f} ms; plain {cs.spread(r['plain_ms'])}; "
              f"{yard}bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{r['launch_splits']} CTAs a slot and head; against plain "
              f"{r['check']}, NaN in the excluded pages "
              f"{r['nan_excluded_pages']}; two launches bitwise equal "
              f"{r['bitwise_repeat']}, graph equal to eager "
              f"{r['graph_equals_eager']} [{card}]", flush=True)
        for n, s in r.get("splits", {}).items():
            print(f"{name} {what}, {n} CTAs a slot and head: events "
                  f"{cs.spread(s['ms'])} ms, graph {s['graph_ms']:.4f} ms, "
                  f"{s['check']} [{card}]", flush=True)
    print(f"{name}: host per wrapper call {rec['host_ms'] * 1e3:.2f} us "
          f"(4 x 4 x 64, G 12); stream handle {rec['current_stream_us']:.3f} "
          f"us (torch.cuda.current_stream), {rec['stream_helper_us']:.3f} us "
          f"(_build.stream) [{card}]", flush=True)
    bad = {k: v for k, v in rec["instances"].items() if not v["ok"]}
    print(f"{name}: {len(rec['instances']) - len(bad)} of "
          f"{len(rec['instances'])} instance cases within PAGED_TOL"
          + (f"; outside: {bad}" if bad else ""), flush=True)
    for line in rec.get("ptxas", []):
        print(f"  {name} {line}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    steps.add_arguments(ap)
    ap.add_argument("--splits", default="")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--dh", default="",
                    help="wider heads to read too, comma-separated")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--probe", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    splits = [int(x) for x in args.splits.split(",") if x]
    dhs = [int(x) for x in args.dh.split(",") if x]
    if args.probe:
        print(json.dumps(phases(dhs)))
        return 0
    if args.child:
        print(json.dumps(child(*steps.child_spec(args), args.reps, splits,
                               dhs)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_paged_steps: no CUDA device is available",
              file=sys.stderr)
        return 2
    variants = [(cu, flags) for _, cu, flags in steps.versions(args).values()
                if cu]
    if args.phases:
        variants.append((os.path.join(steps.CSRC, "paged_attention.cu"),
                         PROFILE))
    sys.path.insert(0, steps.REPO)
    import chip_smoke as cs
    for (cu, flags), log in steps.build_variants("paged_attention",
                                                 variants).items():
        print(f"built {os.path.basename(cu)} {flags}".rstrip(), flush=True)
        for k, line in cs.ptxas_lines(log):
            if shown(k):
                print(f"  {k}: {line}", flush=True)
    child_args = ["--reps", str(args.reps), "--splits", args.splits,
                  "--dh", args.dh]
    records = steps.run(__file__, args, child_args, on_record=report)
    if args.phases:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--probe", "--dh", args.dh],
                              capture_output=True, text=True, timeout=600)
        print(proc.stdout.rsplit("\n", 2)[0], flush=True)
        if proc.returncode != 0:
            print(f"phases: failed\n{proc.stderr[-3000:]}", flush=True)
            return 1
        records.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
