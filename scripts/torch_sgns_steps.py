#!/usr/bin/env python3
"""Hold versions of the sg-ns block kernel B5 side by side on one card
(card only): trees of the repository (each with its own wrapper,
``ops/sgns.py``, and kernel source, ``csrc/sgns.cu``) and kernel sources
run through this checkout's wrapper; and probe this checkout's kernel.

    python3 scripts/torch_sgns_steps.py [--tree NAME=DIR ...] \\
        [--cu NAME=FILE ...] [--flags NAME=FLAGS ...] [--sort-all NAME ...] \\
        [--order NAMES] [--launches N] [--flagship] [--spread] [--phases] \\
        [--negative K,K,...] [--out FILE]

``--tree`` takes a checkout of the repository (for example the parent
commit unpacked by ``git archive`` into ``build/``); ``--cu`` a variant of
``csrc/sgns.cu`` with this checkout's C interface, built with the port's
own ``nvcc`` flags. With neither, the checkout itself is timed. Each
version runs in a process of its own, in the order given by ``--order``
(comma-separated names, repeats allowed: ``parent,new,new,parent``;
``scripts/_torch_steps.py`` runs them).

Each version takes one flagship block (``chip_smoke.flagship_block``:
V=50,000, D=128, C=8192, K=5, the block's Zipf ids), then the same block
with every id redrawn uniformly. For each it holds the kernel against the
plain version on the card (each table within ``SGNS_RTOL``, the loss
within ``SGNS_LOSS_RTOL``; a version outside them is reported, not
stopped), then reads, by CUDA events: each of
``--launches`` launches of the kernel on its own (median, least and
most), and the glue before the launch (``prepare_sgns_block``, median of
5), and a digest of the four tables after one launch, which the
versions' lines compare with the first version's. It prints the
registers of the main instance (from the build's
``-Xptxas -v`` output) and the warps an SM of the cooperative grid. With
``--flagship`` it also runs ``chip_smoke.py``'s phase 4 (``Word2Vec.train``
at bench width: a warm-up block, then 3 timed blocks) and prints
words/sec and pairs/sec; then it trains the same 3 blocks again under
``torch.profiler`` and prints the card's idle time per block (the span
of the device's kernels and copies less their union) and, where the glue
reads ``n_pairs`` on the host, the gap that read leaves on the card (CUDA
events just before and just after it). A version named in ``--sort-all``
runs this checkout's wrapper with the glue sorting every chunk of a block
(no host read of n_pairs) instead of the live chunks only.

``--spread`` and ``--phases`` probe this checkout's kernel, in a process of
their own after the versions:

- ``--spread``: on the flagship block with Zipf ids and with uniform ids,
  and on ``chip_smoke.sgns_layouts``'s ``one_out_id`` (one id in every
  out-lane of a chunk, C=512) at K=16 and K=5, each table of: the plain
  version on the card run twice, the plain version on the CPU, the plain
  version in float64 on the card, and the kernel, each pair's largest
  difference over the second's largest value (``SGNS_RTOL``'s measure).
- ``--phases``: this file's ``csrc/sgns.cu`` built with
  ``-DMV_SGNS_PROFILE`` (thread 0 of every CTA adds the ``clock64()``
  cycles of each phase of each chunk to a device array: pairs, long-run
  listing, the CTA's loss partial, the first grid barrier, the loss sum,
  the long runs, the tiles of short and medium runs, the second grid
  barrier) on the flagship block with both id draws: each phase's mean
  over CTAs and chunks and its largest on one CTA, in microseconds at the
  card's largest SM clock (a phase run below it reads short). With
  ``--negative``, at each K listed: K = 5 is the block as drawn, any other
  K redraws the block's negatives K a pair from its own
  (``chip_smoke.block_negatives``, as phase 2's grouped-variant check
  does; K > 16 runs the grouped variant). Then chunks
  of uniform ids (C=8192, K=5) in which one id fills L out-lanes, L from 0
  to 8,192: the kernel's time per chunk by CUDA events against L.

One JSON record per version (and one for the probes) goes to ``--out``;
every line is printed with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_steps as steps  # noqa: E402

# The main instance (float embeddings, VEC 4, up to 8 negatives), by its
# label in this tree and in trees from before the bfloat16 instance.
MAIN = ("sgns_block_kernelIfLi4ELi8EE", "sgns_block_kernelILi4ELi8EE")


CSRC = os.path.join(steps.CSRC, "sgns.cu")
PROFILE = "-DMV_SGNS_PROFILE"           # csrc/sgns.cu's phase marks
PHASES = ("pairs", "long-run listing", "CTA loss partial", "barrier 1",
          "loss sum", "long runs", "tiles", "barrier 2")


def event_ms(fn) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def spread(values) -> dict:
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values), "readings": values}


def use_library(sgns, path: str, names=("mv_sgns_block",
                                         "mv_sgns_grid_size")):
    """Point the wrapper ``sgns`` at the library ``path`` (a variant build
    with the same C interface)."""
    lib = steps.use_library(sgns, path, names)
    sgns._grid_cache.clear()
    return lib


def device_idle(cs, sgns, sents, d) -> dict:
    """Phase 4's 3 blocks again under ``torch.profiler``: the card's idle
    time per block (span of the device's kernels and copies less their
    union) and, by CUDA events, the gap left on the card at each host read
    of ``n_pairs`` in the glue (none where the glue reads nothing)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from multiverso_tpu_torch.models.word2vec import Word2Vec

    w2v = Word2Vec(cs.flagship_config(), d)
    w2v.train(sentences=sents[:512])            # warm-up block
    reads = []
    n_live = sgns._n_live

    def timed_read(n_pairs, chunk, n):
        before = torch.cuda.Event(enable_timing=True)
        after = torch.cuda.Event(enable_timing=True)
        before.record()
        out = n_live(n_pairs, chunk, n)
        after.record()
        reads.append((before, after))
        return out

    sgns._n_live = timed_read
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            stats = w2v.train(sentences=sents[512:512 * 4])
    finally:
        sgns._n_live = n_live
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and
                   not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    blocks = stats["blocks"]
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    return {"blocks": blocks, "device_events": len(spans),
            "span_ms": span / 1e3 if spans else None,
            "busy_ms": busy / 1e3 if spans else None,
            "idle_ms_per_block": ((span - busy) / 1e3 / blocks
                                  if spans else None),
            "read_gap_us": [a.elapsed_time(b) * 1e3 for a, b in reads]}


def child(tree: str, cu: str, flags: str, launches: int, flagship: bool,
          sort_all: bool) -> dict:
    """One version's readings, in this process."""
    sgns = steps.import_from(tree, "ops.sgns")
    _build = steps.import_from(tree, "ops._build")
    import chip_smoke as cs        # this checkout's inputs and helpers
    import torch
    import multiverso_tpu_torch as mv
    if cu:
        use_library(sgns, steps.variant_library("sgns", cu, flags))
    if sort_all:
        sgns._n_live = lambda n_pairs, chunk, n: n
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mv.init([])
    tables, streams, lr = cs.flagship_block(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    uniform = [torch.randint(0, cs.V, s.shape, generator=g, device=dev,
                             dtype=s.dtype) for s in streams[:3]]
    n_pairs = streams[3]
    out = {}
    for ids, block in (("zipf", streams[:3]), ("uniform", uniform)):
        kern = [t.clone() for t in tables]
        plain = [t.clone() for t in tables]
        lk = float(sgns.sgns_block_cuda(*kern, *block, n_pairs, lr, True))
        lp = float(sgns.sgns_block_plain(*plain, *block, n_pairs, lr, True))
        errs = {name: float((x - y).abs().max())
                for name, x, y in zip(cs.TABLES, kern, plain)}
        within = abs(lk - lp) <= cs.SGNS_LOSS_RTOL * abs(lp) and all(
            errs[name] <= cs.SGNS_RTOL[name] * float(y.abs().max())
            for name, y in zip(cs.TABLES, plain))
        digest = hashlib.sha256()
        for t in kern:
            digest.update(t.cpu().numpy().tobytes())
        work = [t.clone() for t in tables]
        p = sgns.prepare_sgns_block(*work, *block, n_pairs, lr, True)
        sgns.launch_sgns_block(p)                      # warm-up
        ms = [event_ms(lambda: sgns.launch_sgns_block(p))
              for _ in range(launches)]
        glue = [event_ms(lambda: sgns.prepare_sgns_block(
            *work, *block, n_pairs, lr, True)) for _ in range(5)]
        out[ids] = {"ms": spread(ms), "glue_ms": spread(glue),
                    "loss": lk, "plain_loss": lp, "max_abs_err": errs,
                    "within_tolerance": within,
                    "tables_sha256": digest.hexdigest()}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = sgns.grid_size(cs.D, cs.NEG, dev)
    out["grid"] = grid
    out["warps_per_sm"] = grid * 8 / sms
    if not cu:
        out["ptxas"] = [line for kernel, line in
                        cs.ptxas_lines(_build.build_log("sgns"))
                        if kernel in MAIN]
    if flagship:
        d, sents = cs.zipf_corpus(cs.V, 512 * 4, 500)
        stats = cs.flagship(sents, d)
        out["flagship"] = {"words_per_sec": stats["words_per_sec"],
                           "pairs_per_sec": stats["pairs"] / stats["seconds"],
                           "seconds": stats["seconds"],
                           "blocks": stats["blocks"],
                           "idle": device_idle(cs, sgns, sents, d)}
    mv.shutdown()
    return out


def rel_errs(cs, a, b) -> dict:
    """{table: (max |a - b|, that over max |b|)}."""
    out = {}
    for name, x, y in zip(cs.TABLES, a, b):
        err = float((x.double() - y.double().to(x.device)).abs().max())
        out[name] = (err, err / float(y.abs().max()))
    return out


def plain_spread(cs, sgns, dev, card) -> list:
    """The plain version against itself, on the CPU and in float64, and
    the kernel against each, on the flagship block (Zipf and uniform ids)
    and on one_out_id at K=16 and K=5."""
    import torch
    blocks = []
    tables, streams, lr = cs.flagship_block(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    uniform = [torch.randint(0, cs.V, s.shape, generator=g, device=dev,
                             dtype=s.dtype) for s in streams[:3]]
    blocks.append(("flagship zipf", tables, streams[:3], streams[3], lr))
    blocks.append(("flagship uniform", tables, uniform, streams[3], lr))
    g = torch.Generator(device=dev).manual_seed(6)
    for k in (16, 5):
        v = max(4096, 2 * 512 * (1 + k))
        *ids, n_pairs = cs.sgns_layouts(512, k, v,
                                        sgns.LONG_RUN)["one_out_id"]
        layout_tables = tuple(
            f((v, cs.D), generator=g, device=dev) * c
            for f, c in ((torch.randn, 0.1), (torch.randn, 0.1),
                         (torch.rand, 1.0), (torch.rand, 1.0)))
        blocks.append((f"one_out_id K={k}", layout_tables,
                       [torch.as_tensor(x, device=dev) for x in ids],
                       torch.tensor(n_pairs, dtype=torch.int32, device=dev),
                       0.025))
    out = []
    for what, tables, ids, n_pairs, lr in blocks:
        runs, losses = {}, {}

        def run(name, fn, dtype, on):
            t = [x.to(on, dtype).clone() for x in tables]
            losses[name] = float(fn(
                *t, *[x.to(on) for x in ids], n_pairs.to(on), lr, True))
            runs[name] = t

        run("plain", sgns.sgns_block_plain, torch.float32, dev)
        run("plain again", sgns.sgns_block_plain, torch.float32, dev)
        run("plain cpu", sgns.sgns_block_plain, torch.float32, "cpu")
        run("plain float64", sgns.sgns_block_plain, torch.float64, dev)
        run("kernel", sgns.sgns_block_cuda, torch.float32, dev)
        for x, y in (("plain again", "plain"), ("plain cpu", "plain"),
                     ("kernel", "plain"), ("kernel", "plain cpu"),
                     ("plain", "plain float64"),
                     ("plain cpu", "plain float64"),
                     ("kernel", "plain float64")):
            errs = rel_errs(cs, runs[x], runs[y])
            loss = abs(losses[x] - losses[y]) / abs(losses[y])
            out.append({"block": what, "a": x, "b": y, "errs": errs,
                        "loss_rel": loss})
            print(f"{what}: {x} against {y}: " + ", ".join(
                f"{name} {e:.3e} ({r:.3e} of its largest)"
                for name, (e, r) in errs.items())
                + f", loss {loss:.3e} [{card}]", flush=True)
    return out


def one_long_run(cs, sgns, dev, card) -> list:
    """Chunks of uniform ids in which one id fills L out-lanes."""
    import numpy as np
    import torch
    C, K, V, D = 8192, 5, cs.V, cs.D
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(1)
    tables = (0.1 * torch.randn((V, D), generator=g, device=dev),
              0.1 * torch.randn((V, D), generator=g, device=dev),
              torch.rand((V, D), generator=g, device=dev),
              torch.rand((V, D), generator=g, device=dev))
    out = []
    for n in (1, 8):
        for lanes in (0, 64, 256, 823, 2048, 8192):
            cen = rng.integers(0, V, (n, C))
            lane_ids = rng.integers(1, V, (n, C * (1 + K)))
            for i in range(n):
                lane_ids[i, rng.permutation(C * (1 + K))[:lanes]] = 0
            streams = [
                torch.as_tensor(cen, dtype=torch.int32, device=dev),
                torch.as_tensor(lane_ids[:, :C], dtype=torch.int32,
                                device=dev),
                torch.as_tensor(lane_ids[:, C:].reshape(n, C, K),
                                dtype=torch.int32, device=dev)]
            p = sgns.prepare_sgns_block(
                *[t.clone() for t in tables], *streams,
                torch.tensor(n * C, dtype=torch.int32, device=dev), 0.025,
                True)
            ms = cs.cuda_ms(lambda: sgns.launch_sgns_block(p), 5, warmup=1)
            out.append({"chunks": n, "lanes": lanes,
                        "us_per_chunk": ms / n * 1e3})
            print(f"{n} chunk(s) of uniform ids, one id in {lanes} out-lanes "
                  f"of each: {ms / n * 1e3:.1f} us per chunk [{card}]",
                  flush=True)
    return out


def phases(cs, sgns, dev, card, negatives=()) -> dict:
    """Per-phase cycles of a chunk from the kernel built with its phase
    marks, at the block's K and at each of ``negatives``."""
    import ctypes
    import torch
    lib = use_library(sgns, steps.variant_library("sgns", CSRC, PROFILE))
    lib.mv_sgns_profile.argtypes = [ctypes.c_void_p]
    lib.mv_sgns_profile.restype = ctypes.c_int
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    khz = int(float(mhz)) * 1000
    tables, streams, lr = cs.flagship_block(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    uniform = [torch.randint(0, cs.V, s.shape, generator=g, device=dev,
                             dtype=s.dtype) for s in streams[:3]]
    blocks = [("zipf", streams[:3]), ("uniform", uniform)]
    gk = torch.Generator(device=dev).manual_seed(12)
    for k in negatives:
        if k != streams[2].shape[2]:
            blocks.append((f"zipf K={k}", (*streams[:2], cs.block_negatives(
                streams, k, gk))))
    buf = (ctypes.c_ulonglong * 16)()
    result = {}
    for ids, block in blocks:
        work = [t.clone() for t in tables]
        p = sgns.prepare_sgns_block(*work, *block, streams[3], lr, True)
        sgns.launch_sgns_block(p)
        torch.cuda.synchronize()
        lib.mv_sgns_profile(buf)                     # cleared
        launches = 3
        ms = cs.cuda_ms(lambda: sgns.launch_sgns_block(p), launches,
                        warmup=0)
        if lib.mv_sgns_profile(buf) != 0:
            raise RuntimeError("reading the phase counters failed")
        chunks = p.streams[0].shape[0]
        us = lambda cycles: cycles / (khz / 1e3)  # noqa: E731
        rows = {name: {"mean_us": us(buf[k] / p.grid / launches / chunks),
                       "most_us": us(buf[8 + k])}
                for k, name in enumerate(PHASES)}
        result[ids] = {"ms": ms, "chunks": chunks, "grid": p.grid,
                       "phases": rows}
        print(f"{ids} ids, kernel with phase marks: {ms:.4f} ms per block, "
              f"{chunks} chunks, {p.grid} CTAs; per chunk, thread 0 of each "
              f"CTA (clock {khz} kHz) [{card}]:", flush=True)
        for name, r in rows.items():
            print(f"   {name:18s} mean {r['mean_us']:8.2f} us, most on one "
                  f"CTA {r['most_us']:8.2f} us", flush=True)
    return result


def probe(what, negatives=()) -> dict:
    """--spread and --phases on this checkout's kernel, in this process."""
    sys.path.insert(0, steps.REPO)
    import chip_smoke as cs
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.ops import sgns
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    mv.init([])
    record = {"version": "probes", "card": card}
    if "spread" in what:
        record["spread"] = plain_spread(cs, sgns, dev, card)
    if "phases" in what:
        record["one_long_run"] = one_long_run(cs, sgns, dev, card)
        record["phases"] = phases(cs, sgns, dev, card, negatives)
    mv.shutdown()
    return record


def report(records: list, rec: dict) -> None:
    import chip_smoke as cs
    name, card = rec["version"], rec["card"]
    records.append(rec)
    for ids in ("zipf", "uniform"):
        r = rec[ids]
        same = r["tables_sha256"] == records[0][ids]["tables_sha256"]
        print(f"{name} {ids} ids: kernel {cs.spread(r['ms'])} ms per "
              f"block ({len(r['ms']['readings'])} launches), glue "
              f"{r['glue_ms']['median']:.4f} ms, max |kernel - plain| "
              + ", ".join(f"{k} {v:.3e}"
                          for k, v in r["max_abs_err"].items())
              + f" (within SGNS_RTOL and SGNS_LOSS_RTOL: "
              f"{r['within_tolerance']}); tables after one launch "
              f"bitwise equal to "
              f"{records[0]['version']}'s: {same} [{card}]", flush=True)
    print(f"{name}: {rec['grid']} CTAs, {rec['warps_per_sm']:g} warps "
          f"an SM; {MAIN[0]}: {'; '.join(rec['ptxas'])}", flush=True)
    if "flagship" in rec:
        f = rec["flagship"]
        print(f"{name} flagship: {f['words_per_sec']:.6g} words/sec, "
              f"{f['pairs_per_sec']:.6g} pairs/sec over {f['blocks']} "
              f"blocks in {f['seconds']:.4f} s [{card}]", flush=True)
        i = f["idle"]
        idle = ("not measured (the profiler recorded no device time)"
                if i["idle_ms_per_block"] is None else
                f"{i['idle_ms_per_block']:.4f} ms per block idle "
                f"({i['busy_ms']:.4f} ms busy of a {i['span_ms']:.4f} "
                f"ms span, {i['device_events']} device events)")
        gaps = ", ".join(f"{g:.1f}" for g in i["read_gap_us"])
        print(f"{name} flagship under the profiler, {i['blocks']} "
              f"blocks: card {idle}; gap at each host read of n_pairs: "
              f"{gaps or 'no read'} us [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    steps.add_arguments(ap)
    ap.add_argument("--sort-all", action="append", default=[])
    ap.add_argument("--launches", type=int, default=7)
    ap.add_argument("--flagship", action="store_true")
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--negative", default="",
                    help="with --phases, negatives a pair to read too")
    ap.add_argument("--probe", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    negatives = [int(x) for x in args.negative.split(",") if x]
    if args.probe:
        print(json.dumps(probe(args.probe.split(","), negatives)))
        return 0
    if args.child:
        print(json.dumps(child(*steps.child_spec(args), args.launches,
                               args.flagship, bool(args.sort_all))))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_sgns_steps: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, steps.REPO)
    import chip_smoke as cs
    variants = [(cu, flags) for _, cu, flags in steps.versions(args).values()
                if cu]
    if args.phases:
        variants.append((CSRC, PROFILE))
    logs = steps.build_variants("sgns", variants)
    vs = steps.versions(args)
    records = []

    def on_record(rec):
        _, cu, flags = vs[rec["version"]]
        if cu:
            rec["ptxas"] = [line for kernel, line in
                            cs.ptxas_lines(logs[cu, flags])
                            if kernel in MAIN]
        report(records, rec)

    def child_args(name):
        return (["--launches", str(args.launches)]
                + (["--flagship"] if args.flagship else [])
                + (["--sort-all", name] if name in args.sort_all else []))

    steps.run(__file__, args, child_args, on_record=on_record)
    if args.spread or args.phases:
        what = [w for w in ("spread", "phases") if getattr(args, w)]
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--probe",
             ",".join(what), "--negative", args.negative],
            capture_output=True, text=True, timeout=1200)
        print(proc.stdout.rsplit("\n", 2)[0], flush=True)
        if proc.returncode != 0:
            print(f"probes: failed\n{proc.stderr[-3000:]}", flush=True)
            return 1
        records.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
