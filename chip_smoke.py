#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``multiverso_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing here swallows a phase):

1. build every CUDA kernel of the port from ``multiverso_tpu_torch/csrc``
   (one ``nvcc`` per source, started together) and print the card's name
   and power limit;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes, and time kernel, plain version and the one-call
   PyTorch yardstick (``library_ms``) with CUDA events:
   B1 ``gather_rows`` and B2 ``scatter_add_sorted_rows`` (both signs,
   int64 sorted ids as the table plane passes them and int32) with
   100,000 ids into a 1,000,000 x 50 table, bitwise, one B2 call with
   int64 ids launching exactly one CUDA kernel (``torch.profiler``), each
   timed by events in 5 readings of 200 calls in turns with its library
   call (median and range) and in a CUDA graph, the library call too;
   the stateful combine's ``fold_sorted_runs`` on the same ids, bitwise
   to the CPU's lane-order fold, in float32 and float64 on every
   ``stateful_layouts`` layout too; the fused route
   ``fused_stateful_sorted_rows`` (B3 with the combine in it: one stable
   sort, one kernel) for momentum_sgd, adagrad and ftrl from those raw ids
   into a 1,000,000 x 50 table and its state, bitwise against its plain
   version on the CPU, two launches bitwise equal, the kernel, the whole
   Add and the old chain (sort, gather, fold, sentinel ids, B3 on the
   combined lanes) timed in this run, the sort with int32 and int64 keys;
   B3's own signature ``fused_stateful_rows`` (the same kernel, the fold
   off) on the combined input, bitwise; the fused route on every
   ``stateful_layouts`` layout at D = 50 and some at D = 128 and 25, with
   2 workers at worker 1, on all-sentinel and empty batches; B4 ``tiled_scatter_add_sorted_rows`` (both signs and
   id types) with 8,192 sorted ids into 100,000 x 128 (bench.py's shape),
   bitwise, timed as B2, and on runs of up to 20,000 lanes of one row (its
   block-wide ring) at D = 128, 50 and 1,000, bitwise against the plain
   version on the CPU; B2 and B4 on every ``scatter_layouts`` layout at
   row widths ``LAYOUT_COLS`` with int32 and int64 ids, with deltas at an
   odd element offset, with no ids and with out-of-range ids, bitwise; B5
   ``sgns_block`` on one full flagship block (V=50,000, D=128, C=8192,
   K=5, masked tail chunk), each table within ``SGNS_RTOL[table]`` of its
   largest value and the loss within ``SGNS_LOSS_RTOL``, and a second
   launch on the same block bitwise equal to the first; B5's bfloat16
   instance on the same block with bfloat16 embeddings, held chunk by
   chunk (each chunk from the plain version's tables) within
   ``SGNS_BF16_RTOL`` beside the plain version's own spread (the card's
   against the CPU's), the whole block's loss within ``SGNS_LOSS_RTOL``,
   two launches bitwise equal, timed with its byte and operations
   bounds; then every other compiled variant of each kernel once at a
   small shape (row widths 128 and 25, B3 with 2 workers at worker 1,
   all-sentinel and empty batches, B5 with 10 negatives and with D=126,
   and SGD, in float32 and bfloat16), at the same tolerances; B5 on every
   ``sgns_layouts`` layout (runs around its tile, batch and long-run
   edges, one id in every out-lane, a one-lane tail, n_pairs a multiple
   of C, out-of-range ids), some with D=126, SGD and K=1, and K=16 at the
   flagship's chunk with Zipf ids, each in float32 and in bfloat16; the
   plain block step (B5's oracle) run twice on the flagship block,
   bitwise equal;
3. the table plane: ``mv.init()`` on the card, 1,000,000 x 50
   ``use_pallas`` tables: default and sgd updaters (row Adds/Gets at 10%
   coverage against a numpy replay and bitwise against the plain version
   on the CPU; B1 and B2 launched; param updates/sec), then momentum_sgd,
   adagrad and ftrl (3 row Adds of 100,000 ids with duplicates and
   non-default option scalars, bitwise against the same Adds replayed
   through the port's plain path on the CPU, data and every state leaf,
   and within ``MODEL_RTOL``/``MODEL_ATOL`` of a float64 numpy model; the
   fused route launched once an Add, the fold and B3 on combined lanes
   never, and one Add traced by ``torch.profiler`` with one fused launch,
   no fold and no gather of the deltas; B1 launched; param updates/sec
   per updater); float32 tables without the row kernels (default, sgd,
   adagrad, dcasgd: 3 row Adds each with duplicates and out-of-range
   ids, bitwise against the CPU replay; B4 or the fold launched 3
   times); then
   bench.py's row scatter leg, 21 calls of ``tiled_scatter_add_rows``
   (B4 launched 21 times, exact counts); a 1,000,000 x 50 bfloat16
   table with the default updater, 10 row Adds of 100,000 ids with
   duplicates bitwise against the same Adds replayed on the CPU; a
   1,000,000 x 50 bfloat16 table for each of momentum_sgd, adagrad,
   ftrl, dcasgd and dcasgda (3 row Adds of 100,000 ids with duplicates and
   a dense Add, bitwise against the CPU replay, data and every state
   leaf; no fold, fused or B2 launch: the combine folds bfloat16 deltas
   in lane order by a sort and index ops, no float atomics); and one
   1,000,000 x 50 table on each route of a row Add with negative ids
   (default without the row kernels: wrapped; ``use_pallas`` sgd and
   adagrad, plain dcasgd and bfloat16 momentum_sgd: dropped) plus Gets
   with negative ids (clamped), bitwise against the CPU replay;
4. the word2vec flagship through ``Word2Vec.train`` at bench width on a
   synthetic Zipf corpus: one warm-up block, then 3 full blocks with the B5
   kernel launched once per block and a finite loss; words/sec, pairs/sec;
   the same with bfloat16 embeddings (B5's bfloat16 instance) and with
   ``compact_pairs=False`` (bench.py:147-156's legs); then one block each
   of sg-hs, cbow-ns and cbow-hs (the plain block step) and the host
   batch path (``device_pipeline=False``), each a finite loss, no B5
   launch and B4 launched (the plain steps' lane-order row adds);
5. the CLI (``python -m multiverso_tpu_torch.apps.word2vec_main``) on a
   two-topic corpus, skip-gram/NS and ``-cbow -hs``: intra-topic cosine
   must exceed cross-topic cosine;
6. the attention LM (``models/attention_lm.py``) at GPT-2-small widths
   (OpenAI's 124M ``hparams.json``: vocab 50,257, dim 768, 12 heads, 12
   layers, seq 1,024; the repo's own block), batch 8 of cyclic tokens
   (``token[t+1] = (token[t] + 1) mod 17``):
   ``loss()`` with ``-flash_attention`` off and on, in ring and Ulysses
   mode (on: B6 launched exactly 12 times per forward pass, the loss
   within ``LM_LOSS_RTOL`` of the flag-off loss), one untimed ``fit``
   step and 3 timed ones with the flag off (finite losses, and a lower
   loss on a held-out batch after them), then the 8-expert MoE
   configuration at 2 layers (one ``fit`` step, one ``loss()`` with the
   flag on: B6 launched twice);
   tokens/sec of each. Before it, a small LM on the card against the
   same parameters on the CPU (loss and 2 ``fit`` steps);
7. the LM served at the same widths (weights from seed 0) through
   ``ServingService`` and ``ServingClient`` on localhost: 32 prompts of
   ``scripts/serve_bench.py``'s decode workload (seed 7), 8 in flight,
   ``max_new`` 64, 8 slots per engine, buckets 128 and 512, pages of 16,
   in continuous paged mode (B7 launched exactly 12 times per engine
   step), then drain preallocated and drain paged (B7 12 x 63 times per
   batch), then continuous paged and drain paged with int8 pages (B7's
   int8 instance launched exactly 12 times per engine step, and 12 x 63
   per batch; no float32 B7 launch); then, on a variant of the workload
   whose repeated prompt (124 tokens) ends in the straddle page of
   24-position pages at bucket 128, continuous paged without and with the
   prefix cache (8 entries). Every request must be answered; every
   float32 mode's served token must be the argmax of the port's
   teacher-forced full ``forward`` on the card or within ``TIE_ATOL`` of
   its largest logit; the drain modes' tokens must equal the continuous
   ones up to such a tie, drain int8's continuous int8's (ties judged in
   the int8 teacher-forced logits: generated rows attend over K and V
   round-tripped through the codec), and the prefix cache's those of the
   same prompts without it; the prefix run must hit the store, skip
   prefills and copy a straddle page on extend, and leave every page the
   store does not hold free. Per mode: served tokens/sec, first-token and
   per-token latency p50/p99 (device clock), request latency, the pool's
   high-water pages, the pipeline depth; for int8, the share of tokens
   equal to the float32 continuous run's (not gated);
8. a JSON line of the kernels, the card line, and the result line.

Phase 2 also holds B6 (``flash_block_attn``) against its plain version:
at the LM's eval shape (8, 12, 1,024, 64, causal), at the ring-step shapes
of ``scripts/bench_flash_attn.py:41`` (non-causal, timed with both bounds,
3xTF32 on the tensor cores and float32 on the CUDA cores, and
``scaled_dot_product_attention`` as the yardstick), at the LM's widths
with NaN in the K and V rows of the keys no query sees (the kernel skips
their tiles; the plain version gets clean rows), and once each causal
with offsets, fully masked, with a bias, in bfloat16 and at D = 8 and
256, within ``ATTN_TOL``; and B7 (``paged_decode_attn``) at the
serving shape (8 slots, 12 heads, dh 64, page 16, bucket 512, max_new 64:
36 pages per slot) over one layer of a pool of the serving phase's size,
with a page table from real page plans of the workload's lengths, and at
a long-context shape (8 full prompts at bucket 2,048: 132 pages per
slot), each timed with the byte bound and SDPA over the pre-gathered
cache as a yardstick, held with NaN in every page the mask wholly
excludes (the kernel skips them; the plain version gets clean pages), and
launched twice (bitwise equal) and from a CUDA graph (equal to the eager
launch); then with a bfloat16 pool, a page that does not divide the
bucket, an idle slot on the garbage page, t = 0, dh = 128, one small case
per template instance (``PAGED_INSTANCES``), a table of 604 one-row pages
and B x H that fills the card, within ``PAGED_TOL``. B7's int8 instance
(int8 pages read through their float32 scale planes) is held the same
way at both shapes (payloads of 127 and NaN scales in the wholly
excluded pages), timed with its byte bound (dh + 4 bytes a row), and run
once per int8 template instance (``PAGED_INT8_INSTANCES``) and on a page
that does not divide the bucket, an idle slot and t = 0.

Every launch count is set to 0 just before each main-path run of phases
3, 4, 6 and 7 and read just after it, so the comparisons of phase 2 do
not count.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA's data sheet)
FP32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
# B5 tolerance, per table: max |kernel - plain| <= SGNS_RTOL[table] *
# max |plain|. The kernel reduces the dot products with warp shuffles and
# the plain version with torch sums (both add a row's duplicate lanes in
# lane order); the block's 111 chunks carry those roundings on. The
# AdaGrad sums only grow (sums of squares), so they stay close in
# relative terms; an embedding row is a sum of hundreds of steps of both
# signs per chunk, so its rounding differences are large against its
# value. One flagship block on an H100 measured, while the plain version
# still added duplicates by index_add_'s atomics on the card, 9.4e-5
# (w_in, largest |value| 0.54), 2.4e-4 (w_out, 0.83), 1.5e-4 (g_in, 229)
# and 1.8e-4 (g_out, 405). A wrong update of one lane moves a row by
# about lr = 0.025.
SGNS_RTOL = {"w_in": 2e-3, "w_out": 2e-3, "g_in": 1e-5, "g_out": 1e-5}
SGNS_LOSS_RTOL = 1e-4
# B5's bfloat16 instance, per table, the same measure, held chunk by chunk
# (hold_bf16_by_chunk). Kernel and plain version both round each step to
# bfloat16 and add a row's lanes in lane order with a rounding after every
# add; their float32 steps differ as in float32 (the dot products' order),
# and a step that lands on a bfloat16 rounding edge rounds the other way: one
# bfloat16 ulp of the row, which is at most 2^-7 of the table's largest
# value, the limit of w_in and w_out (0.0081 at a largest value of 1.04,
# a third of a 0.025 lr-sized step). Over a whole block no such limit
# holds: a frequent row's AdaGrad steps sit near half an ulp of the row,
# so which of them move it is decided at rounding edges, and each
# difference changes every later gradient. On the flagship block (H100
# 80GB HBM3, 700 W), with the plain version's AdaGrad sums still added by
# atomics on the card, the card's plain version against itself spread 0.22
# (w_in) and 0.61 (w_out) of the largest value, against the CPU's 0.35
# and 0.64; chunk by chunk, from the same tables, the card's plain
# version against the CPU's at most 2.3e-3, 4.0e-3, 3.1e-7 (g_in) and
# 4.3e-7 (g_out), the kernel against the card's 2.3e-3, 4.3e-5, 3.1e-7
# and 4.3e-7.
SGNS_BF16_RTOL = {"w_in": 2**-7, "w_out": 2**-7, "g_in": 1e-5,
                  "g_out": 1e-5}

V, D, CHUNK, NEG = 50_000, 128, 8192, 5
# Row widths of the B2/B4 layout checks: 4-byte, 8-byte and 16-byte loads,
# and lane groups of 1, 4, 8 and 32 (D = 129 takes two passes).
LAYOUT_COLS = (1, 3, 25, 50, 64, 128, 129)
ROWS, COLS, N_IDS = 1_000_000, 50, 100_000

# The attention LM at GPT-2 small's published widths (124M hparams.json).
LM = dict(vocab=50_257, dim=768, heads=12, layers=12, seq=1_024)
LM_BATCH, LM_STEPS = 8, 3
LM_CYCLE = 17          # tokens of the cyclic sequences (test_attention_lm)
MOE_LAYERS, MOE_EXPERTS = 2, 8
# flag-on loss (B6) against flag-off loss (plain block step): the same
# softmax, summed tile by tile instead of in one pass.
LM_LOSS_RTOL = 1e-5
# B6 against its plain version (the JAX flash tests' tolerances,
# tests/test_pallas_attention.py:33-39): the normalised output o / l
# (rtol, atol), l (rtol) and m (rtol; the kernel rescores each row's max
# as a float32 FMA chain in d order, which has matched cuBLAS's bits, but
# cuBLAS's summing order is not a contract).
ATTN_TOL = {"o_rtol": 2e-5, "o_atol": 2e-6, "l_rtol": 2e-5, "m_rtol": 1e-6}
# The ring-step shapes of scripts/bench_flash_attn.py:41 (B, H, S, D).
RING_SHAPES = ((1, 8, 2048, 128), (1, 8, 4096, 128), (2, 16, 2048, 64))
# The serving phase: GPT-2-small widths (LM) served with max_new 64 and 8
# slots per bucket engine over buckets 128 and 512, pages of 16 positions;
# 32 prompts of serve_bench's decode workload, 8 in flight.
SERVE_BUCKETS = (128, 512)
SERVE_MAX_NEW, SERVE_BATCH, SERVE_PAGE = 64, 8, 16
SERVE_REQUESTS, SERVE_IN_FLIGHT = 32, 8
# The prefix-cache mode's pages: 24 positions do not divide bucket 128, so
# the variant workload's repeated 124-token prompt ends in a straddle page
# that a sharer copies on extend; and the store's capacity.
SERVE_PREFIX_PAGE, SERVE_PREFIX_ENTRIES = 24, 8
# B7 against its plain version: the JAX package's tolerances for its
# paged kernel against the gather formulation
# (tests/test_pallas_attention.py:163-199); the kernel sums page by page.
PAGED_TOL = {"rtol": 2e-5, "atol": 2e-6}
# A served token passes the full-forward check if it is the argmax of the
# teacher-forced logits or within this of the largest logit: a tie that
# no float32 summing order can decide (logits of GPT-2-small widths are
# of order 1-10, so 1e-4 is a few float32 roundings of 12 layers).
TIE_ATOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_label(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name in an
    anonymous namespace: ``flash_block_kernelIfLi1EE`` (float, NC 1) for
    ``_ZN45_GLOBAL__N__..._cu_465a24ce18flash_block_kernelIfLi1EEEv...``;
    other names are cut to 48 characters."""
    import re
    outer = re.match(r"_ZN(\d+)", mangled)
    inner = outer and re.compile(r"\d+").match(
        mangled, outer.end() + int(outer.group(1)))
    if not inner:
        return mangled[:48]
    end = inner.end() + int(inner.group())
    args = mangled[end:]
    cut = args.find("EE")
    return mangled[inner.end():end] + (
        args[:cut + 2] if args.startswith("I") and cut >= 0 else "")


def ptxas_lines(build_log: str):
    """(kernel, line) for each registers or spill line of ``nvcc -Xptxas
    -v`` output."""
    kernel = "?"
    for line in build_log.splitlines():
        if "Function properties for" in line:
            kernel = kernel_label(
                line.split("Function properties for", 1)[1].strip())
        elif "registers" in line or "spill" in line:
            yield kernel, line.strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, calls: int = 20) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, replayed ``reps`` times between two events. A small
    kernel's event time over back-to-back wrapper calls (``cuda_ms``) is
    bound by the host's per-call cost (Python, ctypes, the launch); this
    one is not."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps) / calls


def repeat_ms(fns: dict, readings: int = 5, calls: int = 200) -> dict:
    """``cuda_ms`` of each function over ``calls`` back-to-back calls,
    ``readings`` times, the functions in turns (a kernel and its library
    call interleaved); name -> {"median", "min", "max", "readings"}."""
    import statistics
    got = {name: [] for name in fns}
    for _ in range(readings):
        for name, fn in fns.items():
            got[name].append(cuda_ms(fn, calls))
    return {name: {"median": statistics.median(v), "min": min(v),
                   "max": max(v), "readings": v} for name, v in got.items()}


def spread(r: dict) -> str:
    return f"{r['median']:.4f} [{r['min']:.4f}-{r['max']:.4f}]"


def kernels_launched(fn, sessions: int = 3) -> list:
    """The names of the device activities (kernels, copies) that one call
    of ``fn`` starts, traced by ``torch.profiler``. A session that records
    no device activity at all saw nothing: on the H100's machines a
    session now and then comes back empty, in this script's first check
    and in the same calls of earlier trees, while 60 sessions of one B2
    call in a loop came back whole. ``fn`` is then traced again in a new
    session, at most ``sessions`` times; an empty list is returned only if
    every session came back empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            return names
        log("  torch.profiler recorded no device activity; tracing again")
    return []


def bound_ms(n_bytes: float, n_ops: float = 0.0,
             ops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scatter_layouts() -> dict:
    """Sorted id layouts that cross the edges of B2's and B4's tiles (a
    warp owns 32 id slots and reads 64): name -> sorted int64 ids in
    [0, 64). Runs of 33, 65 and 129 equal ids; runs that start at every
    offset mod 8 around each multiple of 32 up to 128 (at 32k + shift,
    shift in -4..3, among random shorter runs); ids whose count leaves
    1-7 lanes of the last group of 8; one run holding every id."""
    import numpy as np
    out = {}
    for length in (33, 65, 129):
        out[f"run_{length}"] = np.array([0, 2, 3] + [5] * length + [7, 7, 11])
    for shift in range(-4, 4):
        rng = np.random.default_rng(100 + shift)
        n = 136
        edge = rng.random(n) < 0.25
        edge[[32 * k + shift for k in range(1, 5)]] = True
        edge[0] = False
        out[f"starts_at_32k{shift:+d}"] = np.cumsum(edge)
    for tail in range(1, 8):
        rng = np.random.default_rng(200 + tail)
        out[f"n_mod_8_is_{tail}"] = np.sort(rng.integers(0, 24, 64 + tail))
    out["one_run"] = np.full(100, 7)
    return {k: v.astype(np.int64) for k, v in out.items()}


def out_of_range_ids(rows: int):
    """Sorted ids with runs below 0 and at or past ``rows``, which the
    scatters drop, around in-range runs."""
    import numpy as np
    return np.array([-9, -3, -3, -1, 0, 4, 4, 4, 9, 30, 30, rows - 1,
                     rows, rows, rows + 5], np.int64)


def runs_to_lanes(lengths, total: int, vocab: int, rng, oor=()):
    """``total`` ids whose stable sort is runs of the given lengths (then
    runs of one id until ``total``), in a random lane order: the k-th run
    holds the k-th smallest id, spread over ``[0, vocab)``, except the runs
    numbered in ``oor``, whose ids lie past the table's end."""
    import numpy as np
    lengths = list(lengths)
    while sum(lengths) > total:
        lengths[-1] -= sum(lengths) - total
        if lengths[-1] <= 0:
            lengths.pop()
    lengths += [1] * (total - sum(lengths))
    assert len(lengths) <= vocab, (len(lengths), vocab)
    ids = np.arange(len(lengths)) * (vocab // len(lengths))
    for k in oor:
        if k < len(ids):
            ids[k] = vocab + k
    return rng.permutation(np.repeat(ids, lengths))


def sgns_layouts(chunk: int, negative: int, vocab: int, long_run: int,
                 n_chunks: int = 3) -> dict:
    """Id layouts that cross the edges of B5's partition
    (``csrc/sgns.cu``): a warp owns a tile of 32 sorted slots and reads 64;
    lane groups apply runs of up to 2 lanes from registers; a warp stages
    the rows of runs shorter than ``long_run``, 16 a round trip, in shared
    memory; a CTA
    streams each longer run through a ring of 4 tiles of 32 lanes (a run
    of at most 128 lanes stays there for both passes) after a k-ary search
    of its end with 256 probes a step. name -> (centers [n, C], contexts
    [n, C], negatives [n, C, K], n_pairs), int32; every chunk is drawn
    anew, its centers and its out-lanes (contexts, then negatives) each
    sorting into the layout's runs.

    - ``one_out_id``: every out-lane of a chunk holds one id (a run of
      C * (1 + K) lanes);
    - ``long_edges``: runs of long_run - 1, long_run, long_run + 1, twice
      and eight times long_run (+-1, +3) and 257 lanes;
    - ``held_edges``: runs of 1-4, 7-9, 15-17 and 24-25 lanes (around the
      register-held runs and a warp's 16-row staging batches);
    - ``tile_edges{s}``: a run starts at every slot 32k + s (k >= 1) and at
      random slots between, so runs cross each tile edge at every offset;
    - ``tail_one_lane``: n_pairs leaves one live lane in the last chunk;
    - ``n_pairs_multiple``: n_pairs = 2 * C exactly (the last chunk dead);
    - ``out_of_range``: runs of ids past the table's end (dropped), long
      ones among them.

    Every other layout ends in a tail chunk of C // 2 + 3 live lanes."""
    import zlib
    import numpy as np
    L, C, K = long_run, chunk, negative
    n_out = C * (1 + K)
    held = [1, 2, 3, 4, 7, 8, 9, 15, 16, 17, 24, 25] * 8
    longs = [L - 1, L, L + 1, 2 * L - 1, 2 * L, 2 * L + 1, 8 * L + 3, 257,
             1, 2, 3]

    def edges(shift, total, rng):
        start = rng.random(total) < 0.3
        start[[32 * k + shift for k in range(1, total // 32 + 1)
               if 32 * k + shift < total]] = True
        start[0] = True
        at = np.flatnonzero(start)
        return np.diff(np.append(at, total)).tolist()

    # name -> (out-lane runs, center runs, out-of-range run numbers of each)
    specs = {"one_out_id": ([n_out], held, ()),
             "long_edges": (longs, longs, ()),
             "held_edges": (held, held, ())}
    for shift in (-3, -1, 0, 1, 3):
        specs[f"tile_edges{shift}"] = (shift, shift, ())
    specs["tail_one_lane"] = (held, held, ())
    specs["n_pairs_multiple"] = (held, held, ())
    specs["out_of_range"] = (longs, held, (1, 3, 7, 9, 12))
    out = {}
    for name, (o_spec, i_spec, oor) in specs.items():
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        centers, contexts, negatives = [], [], []
        for _ in range(n_chunks):
            o_len = edges(o_spec, n_out, rng) if isinstance(o_spec, int) \
                else o_spec
            i_len = edges(i_spec, C, rng) if isinstance(i_spec, int) \
                else i_spec
            lanes = runs_to_lanes(o_len, n_out, vocab, rng, oor)
            centers.append(runs_to_lanes(i_len, C, vocab, rng, oor))
            contexts.append(lanes[:C])
            negatives.append(lanes[C:].reshape(C, K))
        n_pairs = {"tail_one_lane": (n_chunks - 1) * C + 1,
                   "n_pairs_multiple": (n_chunks - 1) * C}.get(
            name, (n_chunks - 1) * C + C // 2 + 3)
        out[name] = (np.stack(centers).astype(np.int32),
                     np.stack(contexts).astype(np.int32),
                     np.stack(negatives).astype(np.int32), n_pairs)
    return out


def zipf_corpus(vocab: int, n_sent: int, sent_len: int, seed: int = 0):
    import numpy as np
    from multiverso_tpu_torch.models.word2vec import Dictionary
    d, zipf = Dictionary.synthetic_zipf(vocab, n_sent * sent_len)
    rng = np.random.default_rng(seed)
    mat = rng.choice(vocab, size=(n_sent, sent_len), p=zipf).astype(np.int32)
    return d, list(mat)


def flagship_config(param_dtype: str = "float32", compact: bool = True,
                    **over):
    from multiverso_tpu_torch.models.word2vec import Word2VecConfig
    # bench.py's headline configuration (bench.py:106-112; its bfloat16
    # and uncompacted legs, bench.py:147-156, through the arguments).
    kw = dict(embedding_size=D, window=5, negative=NEG, batch_size=CHUNK,
              sample=1e-3, sg=True, hs=False, optimizer="adagrad", epochs=1,
              pipeline=True, device_pipeline=True, block_sentences=512,
              pad_sentence_length=512, param_dtype=param_dtype,
              compact_pairs=compact, dispatch_mode=None, seed=0)
    kw.update(over)
    return Word2VecConfig(**kw)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_row_kernels(dev) -> list:
    import torch
    from multiverso_tpu_torch.ops import rows

    g = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn((ROWS, COLS), generator=g, device=dev)
    ids = torch.randint(0, ROWS, (N_IDS,), generator=g, device=dev,
                        dtype=torch.int32)
    uniq = int(torch.unique(ids).numel())
    log(f"B1/B2 shape: {ROWS} x {COLS} table, {N_IDS} ids "
        f"({N_IDS - uniq} duplicates)")

    got = rows.gather_rows(table, ids)
    want = rows.gather_rows_plain(table, ids)
    torch.cuda.synchronize()
    err_b1 = float((got - want).abs().max())
    assert torch.equal(got, want), f"gather_rows differs: {err_b1}"
    ids64 = ids.to(torch.int64)
    b1_plain = cuda_ms(lambda: rows.gather_rows_plain(table, ids), 50)
    b1_graph = graph_ms(lambda: rows.gather_rows(table, ids))
    b1_lib_graph = graph_ms(lambda: torch.index_select(table, 0, ids64))
    b1_bound = bound_ms(N_IDS * 4 + uniq * COLS * 4 + N_IDS * COLS * 4)

    # B2 on the main path's ids: the table plane sorts int64 ids
    # (scatter_add_rows) and B2 reads them as they are.
    sorted_ids, order = torch.sort(ids.to(torch.int64), stable=True)
    sorted32 = sorted_ids.to(torch.int32)
    deltas = torch.randn((N_IDS, COLS), generator=g, device=dev)
    sorted_deltas = deltas.index_select(0, order)
    err_b2 = 0.0
    for sid in (sorted_ids, sorted32):
        for sign in (1.0, -1.0):
            a = table.clone()
            b = table.clone()
            rows.scatter_add_sorted_rows(a, sid, sorted_deltas, sign)
            rows.scatter_add_sorted_rows_plain(b, sid, sorted_deltas, sign)
            torch.cuda.synchronize()
            e = float((a - b).abs().max())
            assert torch.equal(a, b), \
                f"scatter_add {sid.dtype} sign {sign} differs: {e}"
            err_b2 = max(err_b2, e)
    work = table.clone()
    launched = kernels_launched(lambda: rows.scatter_add_sorted_rows(
        work, sorted_ids, sorted_deltas))
    assert len(launched) == 1 and "scatter_runs_kernel" in launched[0], \
        f"one B2 call with int64 ids started {launched}"
    name = launched[0].split("::", 1)[-1].split(">(")[0] + ">"
    log(f"B2 with int64 sorted ids: one call launches one CUDA kernel "
        f"({name}; torch.profiler)")
    b2_plain = cuda_ms(lambda: rows.scatter_add_sorted_rows_plain(
        work, sorted_ids, sorted_deltas), 10)
    b2_bound = bound_ms(N_IDS * 8 + N_IDS * COLS * 4 + 2 * uniq * COLS * 4,
                        N_IDS * COLS)
    b2_graph = graph_ms(lambda: rows.scatter_add_sorted_rows(
        work, sorted_ids, sorted_deltas))
    b2_graph32 = graph_ms(lambda: rows.scatter_add_sorted_rows(
        work, sorted32, sorted_deltas))
    b2_lib_graph = graph_ms(lambda: work.index_add_(0, sorted_ids,
                                                    sorted_deltas))
    # Events readings, each kernel in turns with its library call.
    ev = repeat_ms({
        "gather_rows": lambda: rows.gather_rows(table, ids),
        "index_select": lambda: torch.index_select(table, 0, ids64),
        "scatter_add_sorted_rows": lambda: rows.scatter_add_sorted_rows(
            work, sorted_ids, sorted_deltas),
        "index_add_": lambda: work.index_add_(0, sorted_ids, sorted_deltas)})
    log(f"B1 gather_rows: max_abs_err {err_b1} (bitwise), kernel "
        f"{spread(ev['gather_rows'])} ms by events (median [min-max] of 5 x "
        f"200 calls; {b1_graph:.4f} ms in a CUDA graph), index_select "
        f"{spread(ev['index_select'])} ms ({b1_lib_graph:.4f} in a graph), "
        f"plain {b1_plain:.4f} ms, bound {b1_bound[0]:.4f} ms "
        f"({b1_bound[1]})")
    log(f"B2 scatter_add_sorted_rows (int64 and int32 ids, signs +1, -1): "
        f"max_abs_err {err_b2} (bitwise), kernel "
        f"{spread(ev['scatter_add_sorted_rows'])} ms by events with int64 "
        f"ids ({b2_graph:.4f} ms in a CUDA graph; int32 ids "
        f"{b2_graph32:.4f}), index_add_ {spread(ev['index_add_'])} ms "
        f"({b2_lib_graph:.4f} in a graph), plain {b2_plain:.4f} ms, bound "
        f"{b2_bound[0]:.4f} ms ({b2_bound[1]}, ids at 8 bytes)")
    return [
        {"name": "gather_rows", "route": "cuda",
         "source": "multiverso_tpu_torch/csrc/rows.cu",
         "replaces": "multiverso_tpu/ops/pallas_rows.py:106",
         "max_abs_err": err_b1, "ms": ev["gather_rows"]["median"],
         "ms_readings": ev["gather_rows"]["readings"], "graph_ms": b1_graph,
         "plain_ms": b1_plain,
         "bound_ms": b1_bound[0], "bound_by": b1_bound[1],
         "library_ms": ev["index_select"]["median"],
         "library_ms_readings": ev["index_select"]["readings"],
         "library_graph_ms": b1_lib_graph},
        {"name": "scatter_add_sorted_rows", "route": "cuda",
         "source": "multiverso_tpu_torch/csrc/rows.cu",
         "replaces": "multiverso_tpu/ops/pallas_rows.py:186",
         "max_abs_err": err_b2,
         "ms": ev["scatter_add_sorted_rows"]["median"],
         "ms_readings": ev["scatter_add_sorted_rows"]["readings"],
         "graph_ms": b2_graph, "graph_ms_int32_ids": b2_graph32,
         "plain_ms": b2_plain,
         "bound_ms": b2_bound[0], "bound_by": b2_bound[1],
         "library_ms": ev["index_add_"]["median"],
         "library_ms_readings": ev["index_add_"]["readings"],
         "library_graph_ms": b2_lib_graph},
    ]


STATEFUL = ("momentum_sgd", "adagrad", "ftrl")
# Non-default option scalars of the stateful checks (FTRL reads momentum
# as l2, learning_rate as alpha, rho as beta, lambda_ as l1).
STATEFUL_OPT = dict(worker_id=0, momentum=0.9, learning_rate=0.05, rho=0.1,
                    lambda_=0.01)
# float32 operations per element of each updater's row math.
STATEFUL_OPS = {"momentum_sgd": 4, "adagrad": 8, "ftrl": 16}
# The stateful table plane against a float64 numpy model of the updater:
# |card - model| <= MODEL_ATOL + MODEL_RTOL * |model|, elementwise. The
# card rounds each op to float32 and the model does not; three Adds from
# zero state carry at most a few float32 roundings per element, far
# below these limits, while a wrong update is off by its whole step.
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
B4_ROWS, B4_COLS, B4_IDS = 100_000, 128, 8_192    # bench.py:434-480


def stateful_inputs(g, updater, rows_n, cols, workers, dev):
    """A random table and random state leaves for ``updater`` (the sums
    of squares non-negative)."""
    import torch
    table = torch.randn((rows_n, cols), generator=g, device=dev)
    state = updater.init_state((rows_n, cols), torch.float32, workers, dev)
    for key, leaf in state.items():
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=dev))
        if key in ("g2", "n"):
            leaf.abs_()
    return table, state


def stateful_layouts(rows_n: int = 2_000, n: int = 4_000) -> dict:
    """Row id layouts of the fused stateful route
    (``fused_stateful_sorted_rows``), in lane order: name -> int64 ids.
    All unique; a run of 2,700 equal ids among uniform ones; Zipf ids;
    every lane one id; ids below 0 and at or past ``rows_n`` (some past
    2^31, which would wrap into range if cast to int32); the
    ``scatter_layouts`` runs around the edges of a warp's tile of 32
    slots, shuffled; no ids. ``stateful_deltas`` gives the deltas."""
    import numpy as np
    rng = np.random.default_rng(300)
    out = {"all_unique": rng.permutation(rows_n)[:min(n, rows_n)]}
    long_run = rng.integers(0, rows_n, n)
    long_run[rng.permutation(n)[:2_700]] = 11
    out["run_2700"] = long_run
    out["zipf"] = (rng.zipf(1.3, n) - 1) % rows_n
    out["one_id"] = np.full(n, 5)
    oor = rng.integers(-40, rows_n + 40, n)
    far = rng.permutation(n)[:64]
    oor[far[:16]] = 2 ** 32 + 5           # 5 once cut to 32 bits
    oor[far[16:32]] = -2 ** 32 + 7        # 7 once cut to 32 bits
    oor[far[32:48]] = 2 ** 31
    oor[far[48:]] = -2 ** 31 - 1
    out["out_of_range"] = oor
    out["negative_zero"] = rng.integers(0, rows_n // 4, n)
    for name, ids in scatter_layouts().items():
        out[f"edge_{name}"] = rng.permutation(ids)
    out["empty"] = np.zeros(0)
    return {k: v.astype(np.int64) for k, v in out.items()}


def stateful_deltas(layout: str, n: int, cols: int, rng):
    """Deltas of a ``stateful_layouts`` case: normal, with -0.0 in about
    one lane of 8 (every lane for ``negative_zero``), which the combine's
    fold from 0 turns into +0.0."""
    import numpy as np
    out = rng.normal(size=(n, cols)).astype(np.float32)
    zero = (np.ones(n, bool) if layout == "negative_zero"
            else rng.random(n) < 0.125)
    out[zero] = -0.0
    return out


def stateful_route_pair(updater, table, state, ids, deltas, opt) -> float:
    """The fused route on the card against its plain version on the CPU,
    from the same inputs: every buffer (table and each leaf) must be
    bitwise equal; returns the largest |difference| (0.0)."""
    import torch
    from multiverso_tpu_torch.ops import rows
    a = (table.clone(), {k: v.clone() for k, v in state.items()})
    b = (table.cpu(), {k: v.cpu() for k, v in state.items()})
    rows.fused_stateful_sorted_rows(a[0], a[1], ids, deltas, opt, updater)
    rows.fused_stateful_sorted_rows_plain(b[0], b[1], ids.cpu(),
                                          deltas.cpu(), opt, updater)
    pairs = [("data", a[0].cpu(), b[0])] + [(k, a[1][k].cpu(), b[1][k])
                                            for k in state]
    err = max(float((x - y).abs().max()) for _, x, y in pairs)
    for key, x, y in pairs:
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), \
            (updater.name, key, err)
    return err


def check_stateful_kernels(dev) -> list:
    """The fused route (B3 redesigned, with the combine in it), B3's own
    signature and the combine's fold, at the table plane's width: 100,000
    ids (the B1/B2 draw) into a 1,000,000 x 50 table, each updater bitwise
    against its plain version on the CPU from the same inputs, two
    launches bitwise equal; every ``stateful_layouts`` layout at D = 50
    and some at D = 128 and 25, adagrad with 2 workers at worker 1,
    sentinel and empty batches; the fold in float32 and float64 on the
    main draw and every layout. Times the whole stateful Add both ways in
    this run: the new route (one stable sort, one kernel) and the old
    chain (sort, gather, fold, sentinel ids, B3), and the sort's keys in
    int64 and in int32."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.core.options import AddOption
    from multiverso_tpu_torch.core.updater import (combine_duplicate_rows,
                                                   get_updater)
    from multiverso_tpu_torch.ops import rows

    g = torch.Generator(device=dev).manual_seed(1)
    torch.randn((ROWS, COLS), generator=g, device=dev)   # B1/B2's draw
    ids = torch.randint(0, ROWS, (N_IDS,), generator=g, device=dev,
                        dtype=torch.int32).to(torch.int64)
    deltas = torch.randn((N_IDS, COLS), generator=g, device=dev)

    # The fold of the combine, against the CPU's lane-order index_add_.
    sorted_ids, order = torch.sort(ids, stable=True)
    sorted_deltas = deltas.index_select(0, order)
    got = rows.fold_sorted_runs(sorted_ids, sorted_deltas)
    want = rows.fold_sorted_runs_plain(sorted_ids.cpu(), sorted_deltas.cpu())
    err_fold = float((got.cpu() - want).abs().max())
    assert torch.equal(got.cpu(), want), f"fold differs: {err_fold}"
    fold_variants = []
    lay_rng = np.random.default_rng(301)
    for name, lay in stateful_layouts().items():
        for dt in (torch.float32, torch.float64):
            sid = torch.sort(torch.as_tensor(lay, device=dev))[0]
            sd = torch.as_tensor(stateful_deltas(name, len(lay), 7, lay_rng),
                                 device=dev).to(dt)
            assert torch.equal(rows.fold_sorted_runs(sid, sd).cpu(),
                               rows.fold_sorted_runs_plain(sid.cpu(),
                                                           sd.cpu())), \
                (name, dt)
        fold_variants.append({"layout": name, "cols": 7,
                              "dtypes": ["float32", "float64"],
                              "max_abs_err": 0.0})
    r_eff, d_c = combine_duplicate_rows(ids, deltas, ROWS)
    r_cpu, d_cpu = combine_duplicate_rows(ids.cpu(), deltas.cpu(), ROWS)
    assert torch.equal(r_eff.cpu(), r_cpu) and torch.equal(d_c.cpu(), d_cpu)
    uniq = int((r_eff < ROWS).sum())
    fold_ms = cuda_ms(lambda: rows.fold_sorted_runs(sorted_ids,
                                                    sorted_deltas), 50)
    fold_plain = cuda_ms(lambda: rows.fold_sorted_runs_plain(
        sorted_ids, sorted_deltas), 20)
    fold_graph = graph_ms(lambda: rows.fold_sorted_runs(sorted_ids,
                                                        sorted_deltas))
    glue_ms = cuda_ms(lambda: combine_duplicate_rows(ids, deltas, ROWS), 20)
    fold_bound = bound_ms(N_IDS * 8 + 2 * N_IDS * COLS * 4, N_IDS * COLS)
    log(f"combine fold_sorted_runs: {N_IDS} ids, {uniq} unique, bitwise to "
        f"the CPU's fold (and the whole combine), kernel {fold_ms:.4f} ms "
        f"({fold_graph:.4f} ms in a CUDA graph), "
        f"plain {fold_plain:.4f} ms (index_add_, atomics), whole combine "
        f"(sort, gather, fold) {glue_ms:.4f} ms, bound {fold_bound[0]:.4f} "
        f"ms ({fold_bound[1]}); float32 and float64 bitwise on "
        f"{len(fold_variants)} layouts")
    fold = {"name": "fold_sorted_runs", "route": "cuda",
            "source": "multiverso_tpu_torch/csrc/stateful_rows.cu",
            "replaces": "multiverso_tpu/core/updater.py:124",
            "note": "the combine's segment_sum, an XLA op in the JAX "
                    "package (no Pallas kernel); no single PyTorch call "
                    "gives each lane its run's total",
            "max_abs_err": err_fold, "ms": fold_ms, "graph_ms": fold_graph,
            "plain_ms": fold_plain,
            "bound_ms": fold_bound[0], "bound_by": fold_bound[1],
            "library_ms": None, "combine_ms": glue_ms,
            "variants": fold_variants}

    # The sort before the fused kernel: int32 keys after mapping
    # out-of-range ids to -1 / ROWS (sort_rows), against the int64 sort.
    k32, o32 = rows.sort_rows(ids, ROWS)
    k64, o64 = torch.sort(ids, stable=True)
    assert k32.dtype == torch.int32 and torch.equal(o32, o64)
    sorts = {"int32": lambda: rows.sort_rows(ids, ROWS),
             "int64": lambda: torch.sort(ids, stable=True)}
    sort_ms = {key: cuda_ms(fn, 50) for key, fn in sorts.items()}
    sort_graph = {key: graph_ms(fn) for key, fn in sorts.items()}
    log(f"sort before the fused kernel: int32 keys (clamp, cast, sort) "
        f"{sort_ms['int32']:.4f} ms ({sort_graph['int32']:.4f} in a "
        f"graph), int64 keys {sort_ms['int64']:.4f} ms "
        f"({sort_graph['int64']:.4f}); the same permutation")

    opt = AddOption(**STATEFUL_OPT).scalars()
    variants = []
    for name in STATEFUL:
        up = get_updater(np.float32, name)
        table, state = stateful_inputs(g, up, ROWS, COLS, 1, dev)
        err = stateful_route_pair(up, table, state, ids, deltas, opt)
        # Each run has one owner and a fixed order: a second launch on
        # the same inputs gives the same bits.
        once = (table.clone(), {k: v.clone() for k, v in state.items()})
        twice = (table.clone(), {k: v.clone() for k, v in state.items()})
        rows.fused_stateful_sorted_rows(*once, ids, deltas, opt, up)
        rows.fused_stateful_sorted_rows(*twice, ids, deltas, opt, up)
        for x, y in zip([once[0], *once[1].values()],
                        [twice[0], *twice[1].values()]):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), \
                name
        del once, twice
        # B3's signature (the fold off) from the combined input.
        b3_err = stateful_pair(up, table, state, r_eff, d_c, opt)

        def new():
            rows.fused_stateful_sorted_rows(table, state, ids, deltas, opt,
                                            up)

        def old():
            r, d = combine_duplicate_rows(ids, deltas, ROWS)
            rows.fused_stateful_rows(table, state, r, d, opt, up)

        ev = repeat_ms({"new": new, "old": old}, readings=3, calls=50)
        graph = {"new": graph_ms(new), "old": graph_ms(old)}
        ms = cuda_ms(lambda: rows.fused_stateful_sorted_rows(
            table, state, ids, deltas, opt, up, sort=(k32, o32)), 50)
        kernel_graph = graph_ms(lambda: rows.fused_stateful_sorted_rows(
            table, state, ids, deltas, opt, up, sort=(k32, o32)))
        b3_ms = cuda_ms(lambda: rows.fused_stateful_rows(
            table, state, r_eff, d_c, opt, up), 20)
        b3_graph = graph_ms(lambda: rows.fused_stateful_rows(
            table, state, r_eff, d_c, opt, up))
        plain = cuda_ms(lambda: rows.fused_stateful_sorted_rows_plain(
            table, state, ids, deltas, opt, up), 5)
        leaves = 2 * (1 + len(state)) * uniq * COLS * 4
        n_bytes = N_IDS * (4 + 8) + N_IDS * COLS * 4 + leaves
        bound = bound_ms(n_bytes, N_IDS * COLS + uniq * COLS
                         * STATEFUL_OPS[name])
        b3_bytes = N_IDS * 8 + uniq * COLS * 4 + leaves
        b3_bound = bound_ms(b3_bytes, uniq * COLS * STATEFUL_OPS[name])
        log(f"fused_stateful_sorted_rows [{name}]: {ROWS} x {COLS}, "
            f"{N_IDS} ids ({uniq} unique), bitwise to the CPU plain route, "
            f"two launches bitwise equal; kernel {ms:.4f} ms "
            f"({kernel_graph:.4f} ms in a CUDA graph), bound "
            f"{bound[0]:.4f} ms ({bound[1]}, {n_bytes / 1e6:.1f} MB), plain "
            f"route {plain:.4f} ms; the whole Add {spread(ev['new'])} ms "
            f"({graph['new']:.4f} in a graph) against the old chain (sort, "
            f"gather, fold, sentinel ids, B3) {spread(ev['old'])} ms "
            f"({graph['old']:.4f} in a graph)")
        log(f"B3 fused_stateful_rows [{name}] (the fold off, combined "
            f"lanes): bitwise (max_abs_err {b3_err}), {b3_ms:.4f} ms "
            f"({b3_graph:.4f} in a graph), bound {b3_bound[0]:.4f} ms "
            f"({b3_bytes / 1e6:.1f} MB)")
        variants.append({"updater": name, "cols": COLS, "max_abs_err": err,
                         "ms": ms, "graph_ms": kernel_graph,
                         "plain_ms": plain,
                         "bound_ms": bound[0], "bound_by": bound[1],
                         "library_ms": None,
                         "add_ms": ev["new"]["median"],
                         "add_ms_readings": ev["new"]["readings"],
                         "add_graph_ms": graph["new"],
                         "old_chain_ms": ev["old"]["median"],
                         "old_chain_ms_readings": ev["old"]["readings"],
                         "old_chain_graph_ms": graph["old"],
                         "fold_off_ms": b3_ms, "fold_off_graph_ms": b3_graph,
                         "fold_off_bound_ms": b3_bound[0],
                         "two_launches_bitwise": True})
        del table, state

    # Every layout at D = 50 (the 8-byte loads), some at D = 128 (16-byte)
    # and 25 (4-byte), against the plain route on the CPU.
    small = 2_000
    lay_rng = np.random.default_rng(302)
    layouts = stateful_layouts(small)
    cases = [(name, COLS) for name in layouts]
    cases += [(name, cols) for cols in (128, 25)
              for name in ("zipf", "run_2700", "out_of_range", "empty")]
    for name, cols in cases:
        for upd in STATEFUL:
            up = get_updater(np.float32, upd)
            table, state = stateful_inputs(g, up, small, cols, 1, dev)
            lay = layouts[name]
            stateful_route_pair(
                up, table, state, torch.as_tensor(lay, device=dev),
                torch.as_tensor(stateful_deltas(name, len(lay), cols,
                                                lay_rng), device=dev),
                opt)
        variants.append({"layout": name, "cols": cols,
                         "updaters": list(STATEFUL), "max_abs_err": 0.0})
    log(f"fused_stateful_sorted_rows layouts: {len(cases)} cases x "
        f"{len(STATEFUL)} updaters bitwise to the CPU plain route")
    up = get_updater(np.float32, "adagrad")
    table, state = stateful_inputs(g, up, small, COLS, 2, dev)
    sid = torch.randint(0, small, (1_500,), generator=g, device=dev)
    sd = torch.randn((1_500, COLS), generator=g, device=dev)
    opt1 = AddOption(**dict(STATEFUL_OPT, worker_id=1)).scalars()
    stateful_route_pair(up, table, state, sid, sd, opt1)
    r, d = combine_duplicate_rows(sid, sd, small)
    stateful_pair(up, table, state, r, d, opt1)
    plane0 = state["g2"][0].clone()
    rows.fused_stateful_sorted_rows(table, state, sid, sd, opt1, up)
    rows.fused_stateful_rows(table, state, r, d, opt1, up)
    assert torch.equal(state["g2"][0], plane0), "worker 0's g2 moved"
    variants.append({"updater": "adagrad", "workers": 2, "worker_id": 1,
                     "max_abs_err": 0.0, "other_plane_untouched": True})
    for name in STATEFUL:
        up = get_updater(np.float32, name)
        table, state = stateful_inputs(g, up, small, COLS, 1, dev)
        before = [table.clone()] + [v.clone() for v in state.values()]
        sentinel = torch.full((64,), small, device=dev, dtype=torch.int64)
        launched = dict(rows.LAUNCHES)
        for fn in (rows.fused_stateful_rows, rows.fused_stateful_sorted_rows):
            fn(table, state, sentinel, torch.randn((64, COLS), device=dev),
               opt, up)
            fn(table, state, sentinel[:0], torch.zeros((0, COLS), device=dev),
               opt, up)
        torch.cuda.synchronize()
        for key in ("fused_stateful_rows", "fused_stateful_sorted_rows"):
            assert rows.LAUNCHES[key] == launched[key] + 1, key
        for x, y in zip(before, [table] + list(state.values())):
            assert torch.equal(x, y), f"{name}: a sentinel lane wrote"
    log("fused stateful variants: adagrad with 2 workers at worker 1 "
        "bitwise (both signatures), worker 0's g2 untouched; an "
        "all-sentinel batch and the empty batch leave table and state as "
        "they were")
    # The adagrad line at the main path's width stands for the kernel.
    top = next(v for v in variants if v.get("updater") == "adagrad")
    b3 = {"name": "fused_stateful_sorted_rows", "route": "cuda",
          "source": "multiverso_tpu_torch/csrc/stateful_rows.cu",
          "replaces": "multiverso_tpu/ops/pallas_rows.py:324",
          "note": "B3 with the duplicate combine in it (after one "
                  "stable sort, timed alone as ms; the whole Add, sort "
                  "included, as add_ms); B3's own signature, "
                  "fused_stateful_rows, launches the same kernel with the "
                  "fold off (fold_off_ms)",
          "top_level": "adagrad",
          "library_ms_reason": "no single PyTorch call gathers, updates "
                               "and scatters a table and its state",
          "max_abs_err": max(v["max_abs_err"] for v in variants),
          "ms": top["ms"], "graph_ms": top["graph_ms"],
          "plain_ms": top["plain_ms"],
          "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
          "library_ms": None, "sort_ms": sort_ms,
          "sort_graph_ms": sort_graph, "variants": variants}
    return [b3, fold]


def stateful_pair(updater, table, state, ids, deltas, opt):
    """B3's signature (combined lanes, the fold off) and its plain version
    from the same inputs on the card; returns the largest |difference|
    after asserting that every buffer is equal (the table and each
    leaf)."""
    import torch
    from multiverso_tpu_torch.ops import rows
    a = (table.clone(), {k: v.clone() for k, v in state.items()})
    b = (table.clone(), {k: v.clone() for k, v in state.items()})
    rows.fused_stateful_rows(a[0], a[1], ids, deltas, opt, updater)
    rows.fused_stateful_rows_plain(b[0], b[1], ids, deltas, opt, updater)
    torch.cuda.synchronize()
    pairs = [("data", a[0], b[0])] + [(k, a[1][k], b[1][k]) for k in state]
    err = max(float((x - y).abs().max()) for _, x, y in pairs)
    for key, x, y in pairs:
        assert torch.equal(x, y), (updater.name, key, err)
    return err


def check_tiled_kernel(dev) -> dict:
    """B4 at bench.py's shape, both signs and both id types, bitwise
    against its plain version, timed on the main path's int64 ids (the
    leg's ``tiled_scatter_add_rows`` sorts int64); then its other compiled
    widths once at a small shape."""
    import torch
    from multiverso_tpu_torch.ops import rows

    g = torch.Generator(device=dev).manual_seed(6)
    table = torch.randn((B4_ROWS, B4_COLS), generator=g, device=dev)
    ids = torch.sort(torch.randint(0, B4_ROWS, (B4_IDS,), generator=g,
                                   device=dev))[0]
    ids32 = ids.to(torch.int32)
    deltas = torch.randn((B4_IDS, B4_COLS), generator=g, device=dev)
    uniq = int(torch.unique(ids).numel())
    err = 0.0
    for sid in (ids, ids32):
        for sign in (1.0, -1.0):
            a, b = table.clone(), table.clone()
            rows.tiled_scatter_add_sorted_rows(a, sid, deltas, sign)
            rows.tiled_scatter_add_sorted_rows_plain(b, sid, deltas, sign)
            torch.cuda.synchronize()
            e = float((a - b).abs().max())
            assert torch.equal(a, b), \
                f"tiled scatter {sid.dtype} sign {sign} differs: {e}"
            err = max(err, e)
    work = table.clone()
    plain = cuda_ms(lambda: rows.tiled_scatter_add_sorted_rows_plain(
        work, ids, deltas), 10)
    graph = graph_ms(lambda: rows.tiled_scatter_add_sorted_rows(work, ids,
                                                                deltas))
    graph32 = graph_ms(lambda: rows.tiled_scatter_add_sorted_rows(
        work, ids32, deltas))
    lib_graph = graph_ms(lambda: work.index_add_(0, ids, deltas))
    ev = repeat_ms({
        "kernel": lambda: rows.tiled_scatter_add_sorted_rows(work, ids,
                                                             deltas),
        "index_add_": lambda: work.index_add_(0, ids, deltas)})
    bound = bound_ms(B4_IDS * 8 + B4_IDS * B4_COLS * 4
                     + 2 * uniq * B4_COLS * 4, B4_IDS * B4_COLS)
    variants = [{"cols": B4_COLS, "max_abs_err": err}]
    for cols in (50, 25):
        t = torch.randn((5_000, cols), generator=g, device=dev)
        sid = torch.sort(torch.randint(0, 500, (3_000,), generator=g,
                                       device=dev))[0]
        sd = torch.randn((3_000, cols), generator=g, device=dev)
        for sign in (1.0, -1.0):
            a, b = t.clone(), t.clone()
            rows.tiled_scatter_add_sorted_rows(a, sid, sd, sign)
            rows.tiled_scatter_add_sorted_rows_plain(b, sid, sd, sign)
            assert torch.equal(a, b), (cols, sign)
        variants.append({"cols": cols, "max_abs_err": 0.0})
    # Runs long enough for the block's ring (more than 32 lanes): a word2vec
    # step's pad lanes and frequent ids, up to 20,000 lanes of one row,
    # beside short runs, at the word2vec width (16-byte loads), D = 50 and
    # D = 1,000 (one column a thread in 4 passes of 256), against the
    # plain version on the CPU.
    long_ms = {}
    for cols in (B4_COLS, 50, 1_000):
        t = torch.randn((2_000, cols), generator=g, device=dev)
        lengths = [20_000, 8_192, 4_096, 33, 32, 31, 700]
        ids_l = torch.cat([torch.full((k,), 3 + 5 * i, device=dev)
                           for i, k in enumerate(lengths)]
                          + [torch.randint(0, 2_000, (20_000,), generator=g,
                                           device=dev)])
        sid = torch.sort(ids_l)[0]
        sd = torch.randn((sid.shape[0], cols), generator=g, device=dev)
        for sign in (1.0, -1.0):
            a, b = t.clone(), t.cpu()
            rows.tiled_scatter_add_sorted_rows(a, sid, sd, sign)
            rows.tiled_scatter_add_sorted_rows_plain(b, sid.cpu(), sd.cpu(),
                                                     sign)
            assert torch.equal(a.cpu().view(torch.int32),
                               b.view(torch.int32)), ("long runs", cols, sign)
        long_ms[cols] = graph_ms(lambda: rows.tiled_scatter_add_sorted_rows(
            t, sid, sd), reps=3, calls=3)
        variants.append({"cols": cols, "long_runs": lengths,
                         "max_abs_err": 0.0, "graph_ms": long_ms[cols]})
    log(f"B4 long runs ({', '.join(map(str, lengths))} lanes of one row "
        f"among 20,000 random ids) bitwise to the plain version on the CPU; "
        f"in a CUDA graph " + ", ".join(f"D={c} {v:.4f} ms"
                                        for c, v in long_ms.items()))
    log(f"B4 tiled_scatter_add_sorted_rows (int64 and int32 ids, signs +1, "
        f"-1): {B4_IDS} sorted ids ({uniq} unique) into {B4_ROWS} x "
        f"{B4_COLS}, bitwise, kernel {spread(ev['kernel'])} ms by events "
        f"with int64 ids (median [min-max] of 5 x 200 calls; {graph:.4f} ms "
        f"in a CUDA graph; int32 ids {graph32:.4f}), index_add_ "
        f"{spread(ev['index_add_'])} ms ({lib_graph:.4f} in a graph), plain "
        f"{plain:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, ids at 8 "
        f"bytes); D=50 and D=25 bitwise")
    return {"name": "tiled_scatter_add_sorted_rows", "route": "cuda",
            "source": "multiverso_tpu_torch/csrc/rows.cu",
            "replaces": "multiverso_tpu/ops/pallas_rows.py:430",
            "max_abs_err": err, "ms": ev["kernel"]["median"],
            "ms_readings": ev["kernel"]["readings"], "graph_ms": graph,
            "graph_ms_int32_ids": graph32,
            "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": ev["index_add_"]["median"],
            "library_ms_readings": ev["index_add_"]["readings"],
            "library_graph_ms": lib_graph,
            "variants": variants}


def check_scatter_layouts(dev) -> dict:
    """B2 and B4 against their plain versions, bitwise and with both
    signs, on every ``scatter_layouts`` layout at row widths 1, 3, 25, 50,
    64, 128 and 129 (each vector width and lane group), with int32 and
    int64 ids; then with deltas at an odd element offset (4-byte loads at
    D = 50 and 128), with n = 0 and with out-of-range ids (dropped).
    Returns {kernel: [variant records]}."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.ops import rows

    kernels = ("scatter_add_sorted_rows", "tiled_scatter_add_sorted_rows")
    g = torch.Generator(device=dev).manual_seed(8)
    layouts = scatter_layouts()
    checked = 0

    def hold(kernel, table, ids, deltas, what):
        nonlocal checked
        for sign in (1.0, -1.0):
            a, b = table.clone(), table.clone()
            getattr(rows, kernel)(a, ids, deltas, sign)
            getattr(rows, kernel + "_plain")(b, ids, deltas, sign)
            torch.cuda.synchronize()
            assert torch.equal(a, b), (kernel, what, sign, float(
                (a - b).abs().max()))
            checked += 1

    out = {k: [] for k in kernels}
    for cols in LAYOUT_COLS:
        table = torch.randn((64, cols), generator=g, device=dev)
        for name, ids_np in layouts.items():
            deltas = torch.randn((len(ids_np), cols), generator=g,
                                 device=dev)
            for dtype in (torch.int32, torch.int64):
                ids = torch.as_tensor(ids_np, dtype=dtype, device=dev)
                for k in kernels:
                    hold(k, table, ids, deltas, (name, cols, dtype))
        for k in kernels:
            out[k].append({"cols": cols, "layouts": len(layouts),
                           "max_abs_err": 0.0})
    ids_np = layouts["starts_at_32k+1"]
    for cols in (50, 128):
        table = torch.randn((64, cols), generator=g, device=dev)
        flat = torch.randn((len(ids_np) * cols + 1,), generator=g,
                           device=dev)
        odd = flat[1:].view(len(ids_np), cols)      # 4-byte aligned only
        for dtype in (torch.int32, torch.int64):
            ids = torch.as_tensor(ids_np, dtype=dtype, device=dev)
            for k in kernels:
                hold(k, table, ids, odd, ("odd offset", cols, dtype))
    empty_table = torch.randn((64, 50), generator=g, device=dev)
    before = empty_table.clone()
    oor = torch.as_tensor(out_of_range_ids(64), device=dev)
    oor_deltas = torch.randn((len(oor), 50), generator=g, device=dev)
    for dtype in (torch.int32, torch.int64):
        for k in kernels:
            getattr(rows, k)(empty_table, torch.zeros(0, dtype=dtype,
                                                      device=dev),
                             torch.zeros((0, 50), device=dev))
            hold(k, empty_table, oor.to(dtype), oor_deltas,
                 ("out of range", dtype))
    torch.cuda.synchronize()
    assert torch.equal(empty_table, before), "n = 0 changed the table"
    for k in kernels:
        out[k].append({"odd_offset_deltas": [50, 128], "n_zero": True,
                       "out_of_range": True, "max_abs_err": 0.0})
    log(f"B2/B4 layouts: {len(layouts)} layouts x D {list(LAYOUT_COLS)} x "
        f"int32/int64 ids, deltas at an odd offset (D 50, 128), out-of-range "
        f"ids, both kernels: {checked} calls bitwise to the plain versions "
        f"(both signs); n = 0 leaves the table as it was")
    return out


def flagship_block(dev, param_dtype: str = "float32"):
    """One block of the flagship's main path: a Word2Vec at bench width
    builds the block's pair streams exactly as ``train`` does. The
    embeddings are ``param_dtype``."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.models.word2vec import Word2Vec
    from multiverso_tpu_torch.models.word2vec.model import (pair_gen,
                                                            pair_stream_shape)
    d, sents = zipf_corpus(V, 512, 500, seed=3)
    w2v = Word2Vec(flagship_config(param_dtype), d)
    mat, lens, _ = next(w2v._sentence_blocks(iter(sents)))
    cfg = w2v.cfg
    n, rows_needed, rows_tbl = pair_stream_shape(
        *mat.shape, cfg.window, CHUNK, NEG, w2v._neg_table.shape[0])
    keep_u, wpos, ridx = w2v.draw_randoms(*mat.shape, rows_needed, rows_tbl)
    streams = pair_gen(w2v._neg_table, w2v._keep_prob,
                       torch.as_tensor(mat, device=dev),
                       torch.as_tensor(lens, device=dev), keep_u, wpos, ridx,
                       cfg.window, CHUNK, NEG)
    g = torch.Generator(device=dev).manual_seed(2)
    w_in = w2v.input_table.store.data.clone()
    tables = (w_in,
              (0.1 * torch.randn((V, D), generator=g, device=dev)).to(
                  w_in.dtype),
              torch.zeros((V, D), device=dev),
              torch.zeros((V, D), device=dev))
    return tables, streams, np.float32(cfg.learning_rate)


def sgns_bound(streams, n_live: int, param_bytes: int = 4):
    """Least time for one block: each live lane's ids once, each touched
    row of the four tables read and written once (embeddings of
    ``param_bytes`` a value, float32 AdaGrad sums), and the arithmetic of
    the live pairs (dots, gradients, AdaGrad updates) at float32 rate.
    Returns ``(ms, "bytes" or "operations", bytes ms, operations ms)``."""
    import torch
    centers, contexts, negs, n_pairs = streams
    c = centers[:n_live].reshape(-1)[:int(n_pairs)]
    o = contexts[:n_live].reshape(-1)[:int(n_pairs)]
    k = negs[:n_live].reshape(-1, NEG)[:int(n_pairs)]
    u_in = int(torch.unique(c).numel())
    u_out = int(torch.unique(torch.cat([o, k.reshape(-1)])).numel())
    p = int(n_pairs)
    n_bytes = p * (2 + NEG) * 4 + 2 * (u_in + u_out) * D * (param_bytes + 4)
    flops_per_pair = (2 * D * (1 + NEG) + D * (2 * NEG + 2) + D * (1 + NEG)
                      + 7 * D * (2 + NEG))
    return (*bound_ms(n_bytes, p * flops_per_pair), bound_ms(n_bytes)[0],
            bound_ms(0.0, p * flops_per_pair)[0])


TABLES = ("w_in", "w_out", "g_in", "g_out")


def sgns_table_errs(kern, plain, what: str) -> dict:
    """Max |kernel - plain| of each table, checked against the table's own
    scale; returns {table: error}."""
    import torch
    errs = {}
    for name, a, b in zip(TABLES, kern, plain):
        assert bool(torch.isfinite(a).all()), f"{what}: {name} not finite"
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        log(f"  {what} {name}: max_abs_err {err:.3e}, largest |value| "
            f"{scale:.4g}, limit {SGNS_RTOL[name] * scale:.3e}")
        errs[name] = err
    for name, a, b in zip(TABLES, kern, plain):
        assert errs[name] <= SGNS_RTOL[name] * float(b.abs().max()), \
            f"{what}: {name} differs by {errs[name]}"
    return errs


def table_spread(a_tables, b_tables) -> str:
    """Each table's max |a - b| over b's largest |value| (the measure of
    ``SGNS_RTOL``)."""
    out = []
    for name, a, b in zip(TABLES, a_tables, b_tables):
        a, b = a.float().cpu(), b.float().cpu()
        out.append(f"{name} {float((a - b).abs().max()) / float(b.abs().max()):.3e}")
    return ", ".join(out)


def check_sgns_kernel(dev) -> dict:
    import torch
    from multiverso_tpu_torch.ops import sgns

    tables, streams, lr = flagship_block(dev)
    centers, contexts, negs, n_pairs = streams
    n_live = (int(n_pairs) + CHUNK - 1) // CHUNK
    log(f"B5 shape: V={V} D={D} C={CHUNK} K={NEG}; block of "
        f"{int(n_pairs)} pairs = {n_live} live chunks of "
        f"{centers.shape[0]}, tail chunk {int(n_pairs) % CHUNK} live lanes")
    assert int(n_pairs) % CHUNK != 0, "the block must end in a masked tail"
    kern = [t.clone() for t in tables]
    plain = [t.clone() for t in tables]
    loss_k = sgns.sgns_block_cuda(*kern, *streams[:3], n_pairs, lr, True)
    loss_p = sgns.sgns_block_plain(*plain, *streams[:3], n_pairs, lr, True)
    torch.cuda.synchronize()
    lk, lp = float(loss_k), float(loss_p)
    log(f"B5 sgns_block: loss {lk} vs plain {lp}; per table:")
    errs = sgns_table_errs(kern, plain, "B5")
    err = max(errs.values())
    assert abs(lk - lp) <= SGNS_LOSS_RTOL * abs(lp), (lk, lp)
    # Each run has one owner and every sum a fixed order: a second launch
    # on the same inputs gives the same bits.
    twice = [t.clone() for t in tables]
    loss_2 = sgns.sgns_block_cuda(*twice, *streams[:3], n_pairs, lr, True)
    torch.cuda.synchronize()
    assert float(loss_2) == lk, (float(loss_2), lk)
    for name, a, b in zip(TABLES, twice, kern):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    log("B5 sgns_block: a second launch on the same block gives bitwise-"
        "equal tables and loss")
    # The plain block step adds a row's duplicates in lane order on the
    # card too (ops/rows.add_rows_sorted: a stable sort and B4, never
    # index_add_'s float atomics), so a second run gives the same bits.
    again = [t.clone() for t in tables]
    loss_again = sgns.sgns_block_plain(*again, *streams[:3], n_pairs, lr,
                                       True)
    torch.cuda.synchronize()
    assert float(loss_again) == lp, (float(loss_again), lp)
    for name, a, b in zip(TABLES, again, plain):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    log("B5 plain vs plain: the plain block step run twice on the card "
        "gives bitwise-equal tables and loss")
    launch = sgns.prepare_sgns_block(*[t.clone() for t in tables],
                                     *streams[:3], n_pairs, lr, True)
    ms = cuda_ms(lambda: sgns.launch_sgns_block(launch), 5, warmup=1)
    glue_ms = cuda_ms(lambda: sgns.prepare_sgns_block(
        *launch.tables, *streams[:3], n_pairs, lr, True), 5, warmup=1)
    work = [t.clone() for t in tables]
    plain_ms = cuda_ms(lambda: sgns.sgns_block_plain(
        *work, *streams[:3], n_pairs, lr, True), 2, warmup=1)
    bound = sgns_bound(streams, n_live)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"B5 sgns_block: kernel {ms:.4f} ms per block ({launch.grid} CTAs "
        f"x 256 threads, cooperative: {launch.grid * 8 / sms:g} warps an "
        f"SM), glue sort {glue_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]}; bytes {bound[2]:.4f}, operations "
        f"{bound[3]:.4f})")
    # Where the time goes: the same block with every row id redrawn
    # uniformly keeps the work per lane and removes the long runs of one
    # frequent id that a single warp applies lane after lane.
    g = torch.Generator(device=dev).manual_seed(4)
    uniform = [torch.randint(0, V, s.shape, generator=g, device=dev,
                             dtype=s.dtype) for s in streams[:3]]
    longest = int(torch.unique(launch.sorted_streams[2][0],
                               return_counts=True)[1].max())
    flat = sgns.prepare_sgns_block(*[t.clone() for t in tables], *uniform,
                                   n_pairs, lr, True)
    flat_longest = int(torch.unique(flat.sorted_streams[2][0],
                                    return_counts=True)[1].max())
    flat_ms = cuda_ms(lambda: sgns.launch_sgns_block(flat), 5, warmup=1)
    log(f"B5 sgns_block where the time goes: {ms:.4f} ms with the block's "
        f"Zipf ids (longest run of one out-row id in chunk 0: {longest} "
        f"lanes) vs {flat_ms:.4f} ms with uniform ids (longest run "
        f"{flat_longest} lanes)")
    return {"name": "sgns_block", "route": "cuda",
            "source": "multiverso_tpu_torch/csrc/sgns.cu",
            "replaces": "multiverso_tpu/ops/pallas_sgns.py:122",
            "max_abs_err": err, "max_abs_err_tables": errs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "bound_bytes_ms": bound[2], "bound_ops_ms": bound[3],
            "library_ms": None}


def hold_bf16_by_chunk(tables, streams, n_pairs, lr, adagrad, what: str,
                       cpu_spread: bool = False) -> dict:
    """B5's bfloat16 instance held against its plain version chunk by
    chunk: for each live chunk of the block, kernel and plain version
    start from the same tables (the plain version's after the chunks
    before), train that chunk alone, and must agree within
    ``SGNS_BF16_RTOL`` (each table's max |kernel - plain| over its largest
    |value|) and the chunk's loss within ``SGNS_LOSS_RTOL``. A whole
    block cannot be held so: there one rounding edge that the two cross
    differently changes the steps of every later chunk (see
    ``SGNS_BF16_RTOL``). With ``cpu_spread`` the same chunk also runs
    through the plain version on the CPU, and the card's plain version is
    measured against it (the spread the tolerance is set from). Returns
    the worst of each over the chunks, per table."""
    import torch
    from multiverso_tpu_torch.ops import sgns

    chunk = streams[0].shape[1]
    n_pairs = int(n_pairs)
    ref = [t.clone() for t in tables]
    worst = {name: 0.0 for name in TABLES}
    worst_abs = {name: 0.0 for name in TABLES}
    spread_cpu = {name: 0.0 for name in TABLES}
    worst_loss = 0.0
    for i in range((n_pairs + chunk - 1) // chunk):
        part = [s[i:i + 1] for s in streams[:3]]
        live = torch.tensor(min(n_pairs - i * chunk, chunk),
                            dtype=torch.int32, device=ref[0].device)
        kern = [t.clone() for t in ref]
        cpu = [t.cpu() for t in ref] if cpu_spread else None
        lk = float(sgns.sgns_block_cuda(*kern, *part, live, lr, adagrad))
        lp = float(sgns.sgns_block_plain(*ref, *part, live, lr, adagrad))
        if lp:
            worst_loss = max(worst_loss, abs(lk - lp) / abs(lp))
        for name, a, b in zip(TABLES, kern, ref):
            a, b = a.float(), b.float()
            assert bool(torch.isfinite(a).all()), (what, i, name)
            err = float((a - b).abs().max())
            worst_abs[name] = max(worst_abs[name], err)
            scale = float(b.abs().max())
            if scale:
                worst[name] = max(worst[name], err / scale)
        if cpu_spread:
            sgns.sgns_block_plain(*cpu, *[x.cpu() for x in part],
                                  int(live), lr, adagrad)
            for name, a, b in zip(TABLES, ref, cpu):
                a, b = a.float().cpu(), b.float()
                scale = float(b.abs().max())
                if scale:
                    spread_cpu[name] = max(spread_cpu[name], float(
                        (a - b).abs().max()) / scale)
    log(f"{what}, chunk by chunk: kernel vs plain, worst over chunks of "
        f"max|err| / max|value|: " + ", ".join(
            f"{k} {v:.3e} (limit {SGNS_BF16_RTOL[k]:.2g})"
            for k, v in worst.items()) + f"; loss {worst_loss:.3e}"
        + ("; the card's plain vs the CPU's: " + ", ".join(
            f"{k} {v:.3e}" for k, v in spread_cpu.items())
           if cpu_spread else ""))
    for name in TABLES:
        assert worst[name] <= SGNS_BF16_RTOL[name], (what, name, worst)
    assert worst_loss <= SGNS_LOSS_RTOL, (what, worst_loss)
    out = {"max_rel_err_tables": worst, "max_abs_err_tables": worst_abs,
           "max_loss_rel_err": worst_loss}
    if cpu_spread:
        out["plain_card_vs_cpu"] = spread_cpu
    return out


def check_sgns_kernel_bf16(dev) -> dict:
    """B5's bfloat16 instance on the flagship block with bfloat16
    embeddings (bench.py's ``w2v_words_per_sec_bf16`` leg): held against
    the card's plain version chunk by chunk (``hold_bf16_by_chunk``, with
    the spread of the card's plain version against the CPU's); the whole
    block once through each, the loss within ``SGNS_LOSS_RTOL`` and the
    tables' spread printed beside the plain version's own (on the card
    twice, and the card's against the CPU's); two launches bitwise equal;
    timed by events with the byte bound at 2-byte rows and the operations
    bound."""
    import torch
    from multiverso_tpu_torch.ops import sgns

    tables, streams, lr = flagship_block(dev, "bfloat16")
    assert tables[0].dtype == tables[1].dtype == torch.bfloat16
    centers, contexts, negs, n_pairs = streams
    n_live = (int(n_pairs) + CHUNK - 1) // CHUNK
    log(f"B5 bf16 sgns_block: {int(n_pairs)} pairs, {n_live} live chunks")
    by_chunk = hold_bf16_by_chunk(tables, streams, n_pairs, lr, True,
                                  "B5 bf16 flagship block",
                                  cpu_spread=True)
    kern = [t.clone() for t in tables]
    plain = [t.clone() for t in tables]
    loss_k = sgns.sgns_block_cuda(*kern, *streams[:3], n_pairs, lr, True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    loss_p = sgns.sgns_block_plain(*plain, *streams[:3], n_pairs, lr, True)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    lk, lp = float(loss_k), float(loss_p)
    assert abs(lk - lp) <= SGNS_LOSS_RTOL * abs(lp), (lk, lp)
    twice = [t.clone() for t in tables]
    loss_2 = sgns.sgns_block_cuda(*twice, *streams[:3], n_pairs, lr, True)
    torch.cuda.synchronize()
    assert float(loss_2) == lk, (float(loss_2), lk)
    for name, a, b in zip(TABLES, twice, kern):
        assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16
                                  else torch.int32)), name
    again = [t.clone() for t in tables]
    sgns.sgns_block_plain(*again, *streams[:3], n_pairs, lr, True)
    cpu = [t.cpu() for t in tables]
    sgns.sgns_block_plain(*cpu, *[s.cpu() for s in streams[:3]],
                          int(n_pairs), lr, True)
    whole = {"kernel_vs_plain": table_spread(kern, plain),
             "plain_vs_plain": table_spread(again, plain),
             "plain_card_vs_cpu": table_spread(plain, cpu),
             "kernel_vs_cpu": table_spread(kern, cpu)}
    log(f"B5 bf16 whole block: loss {lk} vs plain {lp}; two launches "
        f"bitwise equal; max|a - b| / max|b| per table: " + "; ".join(
            f"{k} {v}" for k, v in whole.items()))
    launch = sgns.prepare_sgns_block(*[t.clone() for t in tables],
                                     *streams[:3], n_pairs, lr, True)
    ms = cuda_ms(lambda: sgns.launch_sgns_block(launch), 5, warmup=1)
    glue_ms = cuda_ms(lambda: sgns.prepare_sgns_block(
        *launch.tables, *streams[:3], n_pairs, lr, True), 5, warmup=1)
    bound = sgns_bound(streams, n_live, param_bytes=2)
    log(f"B5 bf16 sgns_block: kernel {ms:.4f} ms per block ({launch.grid} "
        f"CTAs), glue sort {glue_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]}; bytes {bound[2]:.4f} at 2-byte "
        f"rows, operations {bound[3]:.4f})")
    err = max(by_chunk["max_abs_err_tables"].values())
    return {"name": "sgns_block_bf16", "route": "cuda",
            "source": "multiverso_tpu_torch/csrc/sgns.cu",
            "replaces": "multiverso_tpu/ops/pallas_sgns.py:122",
            "max_abs_err": err, "by_chunk": by_chunk, "whole_block": whole,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "bound_bytes_ms": bound[2],
            "bound_ops_ms": bound[3], "library_ms": None}


def check_variants(dev) -> dict:
    """Every compiled variant the main path does not reach, once at a small
    shape against its plain version: the row kernels at widths 128 (16-byte
    loads) and 25 (4-byte loads; the main path's 50 takes 8-byte loads),
    bitwise; B5 built for 16 negatives (K=10), for widths that are not a
    multiple of 4 (D=126, with K=5 and K=10), and SGD, with skewed ids so
    long runs take the CTA path, each with float32 and with bfloat16
    embeddings. Returns {kernel: [variant records]}."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.ops import rows, sgns

    g = torch.Generator(device=dev).manual_seed(5)
    out = {"gather_rows": [], "scatter_add_sorted_rows": []}
    for cols in (128, 25):
        table = torch.randn((20_000, cols), generator=g, device=dev)
        ids = torch.randint(0, 2_000, (5_000,), generator=g, device=dev,
                            dtype=torch.int32)
        assert torch.equal(rows.gather_rows(table, ids),
                           rows.gather_rows_plain(table, ids)), cols
        sid = torch.sort(ids)[0]
        deltas = torch.randn((5_000, cols), generator=g, device=dev)
        for sign in (1.0, -1.0):
            a, b = table.clone(), table.clone()
            rows.scatter_add_sorted_rows(a, sid, deltas, sign)
            rows.scatter_add_sorted_rows_plain(b, sid, deltas, sign)
            assert torch.equal(a, b), (cols, sign)
        out["gather_rows"].append({"cols": cols, "max_abs_err": 0.0})
        out["scatter_add_sorted_rows"].append({"cols": cols,
                                               "max_abs_err": 0.0})
        log(f"B1/B2 variant D={cols}: 5,000 ids (2,000 rows) bitwise")

    v, c, n = 2_000, 1_024, 4
    zipf = 1.0 / np.arange(1, v + 1)
    zipf = torch.as_tensor(zipf / zipf.sum(), dtype=torch.float32,
                           device=dev)

    def draw(*shape):
        return torch.multinomial(zipf, int(np.prod(shape)), True,
                                 generator=g).to(torch.int32).view(shape)

    out["sgns_block"] = []
    out["sgns_block_bf16"] = []
    for d, k, adagrad, dt in [(*c, dt) for dt in (torch.float32,
                                                  torch.bfloat16)
                              for c in ((128, 10, True), (126, 5, True),
                                        (126, 10, True), (128, 5, False))]:
        streams = (draw(n, c), draw(n, c), draw(n, c, k))
        n_pairs = torch.tensor(3 * c + 517, dtype=torch.int32, device=dev)
        tables = ((0.1 * torch.randn((v, d), generator=g, device=dev)
                   ).to(dt),
                  (0.1 * torch.randn((v, d), generator=g, device=dev)
                   ).to(dt),
                  torch.zeros((v, d), device=dev),
                  torch.zeros((v, d), device=dev))
        bf16 = dt == torch.bfloat16
        what = (f"B5 variant D={d} K={k} {'adagrad' if adagrad else 'sgd'}"
                f"{' bf16' if bf16 else ''}")
        rec = {"d": d, "k": k, "adagrad": adagrad}
        if bf16:
            rec.update(hold_bf16_by_chunk(tables, streams, n_pairs, 0.025,
                                          adagrad, what))
            out["sgns_block_bf16"].append(rec)
            continue
        kern = [t.clone() for t in tables]
        plain = [t.clone() for t in tables]
        lk = float(sgns.sgns_block_cuda(*kern, *streams, n_pairs, 0.025,
                                        adagrad))
        lp = float(sgns.sgns_block_plain(*plain, *streams, n_pairs, 0.025,
                                         adagrad))
        log(f"{what}: V={v} C={c}, 3 full chunks + a tail of 517; loss "
            f"{lk} vs plain {lp}")
        rec["max_abs_err_tables"] = sgns_table_errs(kern, plain, what)
        assert abs(lk - lp) <= SGNS_LOSS_RTOL * abs(lp), (what, lk, lp)
        out["sgns_block"].append(rec)
    return out


def check_sgns_layouts(dev) -> list:
    """B5 against its plain version on ``sgns_layouts`` (C=512, K=5,
    V=6,144, D=128, AdaGrad; runs around the built kernel's long-run
    length, which must be ``sgns.LONG_RUN``), then a few layouts with
    D=126, with SGD and with K=1, and K=16 at the flagship's chunk and
    vocabulary with Zipf ids (more tiles of 32 slots than the grid has
    warps, so tiles are also taken from the chunk's counter), each table
    within ``SGNS_RTOL`` and the
    loss within ``SGNS_LOSS_RTOL``; then all of it again with bfloat16
    embeddings, chunk by chunk within ``SGNS_BF16_RTOL``.
    Returns the variant records (``bf16`` marks the instance)."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.ops import sgns

    # The layouts put runs at the built kernel's long-run edge.
    assert sgns.kernel_long_run() == sgns.LONG_RUN, (
        sgns.kernel_long_run(), sgns.LONG_RUN)
    g = torch.Generator(device=dev).manual_seed(6)
    c = 512

    def tables_for(vocab, d, dtype=torch.float32):
        return ((0.1 * torch.randn((vocab, d), generator=g, device=dev)
                 ).to(dtype),
                (0.1 * torch.randn((vocab, d), generator=g, device=dev)
                 ).to(dtype),
                torch.rand((vocab, d), generator=g, device=dev),
                torch.rand((vocab, d), generator=g, device=dev))

    def hold(what, tables, streams, n_pairs, adagrad):
        if tables[0].dtype == torch.bfloat16:
            return {"layout": what, "bf16": True, **hold_bf16_by_chunk(
                tables, streams, n_pairs, 0.025, adagrad, what)}
        kern = [t.clone() for t in tables]
        plain = [t.clone() for t in tables]
        n_pairs = torch.tensor(n_pairs, dtype=torch.int32, device=dev)
        lk = float(sgns.sgns_block_cuda(*kern, *streams, n_pairs, 0.025,
                                        adagrad))
        lp = float(sgns.sgns_block_plain(*plain, *streams, n_pairs, 0.025,
                                         adagrad))
        log(f"{what}: loss {lk} vs plain {lp}")
        errs = sgns_table_errs(kern, plain, what)
        assert abs(lk - lp) <= SGNS_LOSS_RTOL * abs(lp), (what, lk, lp)
        return {"layout": what, "max_abs_err_tables": errs, "bf16": False}

    def vocab(k):                      # room for a run per out-lane
        return max(4096, 2 * c * (1 + k))

    out = []
    layouts = {k: sgns_layouts(c, k, vocab(k), sgns.LONG_RUN)
               for k in (1, 5, 16)}
    cases = [(name, 5, 128, True) for name in layouts[5]]
    cases += [("tile_edges0", 5, 126, True), ("long_edges", 5, 126, True),
              ("one_out_id", 5, 128, False), ("long_edges", 5, 128, False),
              ("held_edges", 1, 128, True), ("long_edges", 1, 128, True),
              ("tile_edges0", 16, 128, True), ("long_edges", 16, 128, True)]
    # The bfloat16 instance on every layout and every case above.
    cases = [(*c, dt) for dt in (torch.float32, torch.bfloat16)
             for c in cases]
    for name, k, d, adagrad, dt in cases:
        *np_streams, n_pairs = layouts[k][name]
        streams = [torch.as_tensor(x, device=dev) for x in np_streams]
        out.append(hold(f"B5 layout {name} K={k} D={d} "
                        f"{'adagrad' if adagrad else 'sgd'}"
                        f"{' bf16' if dt == torch.bfloat16 else ''}",
                        tables_for(vocab(k), d, dt), streams, n_pairs,
                        adagrad))
    zipf = 1.0 / np.arange(1, V + 1)
    zipf = torch.as_tensor(zipf / zipf.sum(), dtype=torch.float32,
                           device=dev)
    n, k = 2, 16
    streams = [torch.multinomial(zipf, int(np.prod(shape)), True,
                                 generator=g).to(torch.int32).view(shape)
               for shape in ((n, CHUNK), (n, CHUNK), (n, CHUNK, k))]
    # A run of ~2,700 lanes of the most frequent negative: the plain
    # version on the card adds its AdaGrad squares in lane order, as the
    # kernel does (before the repair of ROADMAP C4 it added them by
    # atomics, and its g_in and g_out spread past SGNS_RTOL in some
    # repeats, so this case was held on the CPU).
    for dt in (torch.float32, torch.bfloat16):
        out.append(hold(f"B5 K={k} C={CHUNK} V={V} Zipf ids"
                        f"{' bf16' if dt == torch.bfloat16 else ''}",
                        tables_for(V, D, dt), streams, CHUNK + 4097, True))
    log(f"B5 layouts: {len(out)} cases (float32 and bfloat16) within "
        f"SGNS_RTOL / SGNS_BF16_RTOL and SGNS_LOSS_RTOL")
    return out


# ---------------------------------------------------------------------------
# phase 2 (B6): flash block attention against its plain version
# ---------------------------------------------------------------------------
def attn_inputs(g, dev, b, h, sq, sk, dh):
    import torch
    return tuple(torch.randn((b, h, s, dh), generator=g, device=dev)
                 for s in (sq, sk, sk))


def attn_compare(what, got, want) -> float:
    """Hold B6's (o, m, l) against the plain version's within
    ``ATTN_TOL``; returns the largest |difference| of o / l."""
    import torch
    torch.cuda.synchronize()
    (o2, m2, l2), (o1, m1, l1) = got, want
    for t in got:
        assert bool(torch.isfinite(t).all()), f"{what}: not finite"
    n2 = o2 / torch.clamp(l2, min=1e-20)
    n1 = o1 / torch.clamp(l1, min=1e-20)
    err = float((n2 - n1).abs().max())
    l_err = float(((l2 - l1).abs() / l1.abs()).max())
    m_err = float(((m2 - m1).abs() / m1.abs()).max())
    log(f"  {what}: max |o/l - plain| {err:.3e}, max rel l {l_err:.3e}, "
        f"max rel m {m_err:.3e}")
    assert bool(((n2 - n1).abs() <= ATTN_TOL["o_atol"]
                 + ATTN_TOL["o_rtol"] * n1.abs()).all()), (what, err)
    assert l_err <= ATTN_TOL["l_rtol"], (what, l_err)
    assert m_err <= ATTN_TOL["m_rtol"], (what, m_err)
    return err


def attn_bounds(b, h, sq, sk, dh, causal=False, offsets=(0, 0)) -> dict:
    """B6's two bounds. q, k, v read and o written once in float32, plus
    m and l; both products (4 D operations) over each (q, k) pair whose
    score counts. With ``causal``, a masked score adds exp(-1e30 - m) = 0
    to a row that sees any key, so only its unmasked pairs count; a row
    that sees none comes out as o = the sum of v (D adds per key). The
    kernel's route takes each float32 product as three TF32 products on
    the tensor cores (``bound_ms``); beside it the same operations on the
    float32 CUDA cores (``bound_cuda_core_ms``)."""
    q_off, k_off = offsets
    n_ops = 0
    for i in range(sq):
        seen = min(max(q_off + i - k_off + 1, 0), sk) if causal else sk
        n_ops += 4 * dh * seen if seen else dh * sk
    n_bytes = (2 * sq + 2 * sk) * b * h * dh * 4 + 2 * b * h * sq * 4
    tc = bound_ms(n_bytes, 3.0 * b * h * n_ops, TF32_FLOPS_PER_S)
    cc = bound_ms(n_bytes, float(b * h * n_ops))
    return {"bound_ms": tc[0], "bound_by": tc[1],
            "bound_route": "3xTF32 on the tensor cores",
            "bound_cuda_core_ms": cc[0], "bound_cuda_core_by": cc[1]}


def bounds_text(bd: dict) -> str:
    return (f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
            f"{bd['bound_route']}; float32 CUDA cores "
            f"{bd['bound_cuda_core_ms']:.4f} ms)")


def sdpa_backend(q, k, v, causal) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these
    inputs."""
    import torch
    from torch.nn.attention import SDPBackend
    names = {int(val): key for key, val in SDPBackend.__members__.items()}
    return names.get(int(torch._fused_sdp_choice(q, k, v, None, 0.0,
                                                 causal)), "unknown")


def time_attn(q, k, v, causal, reps) -> dict:
    """B6 by events over back-to-back calls and in a CUDA graph, its plain
    version, and the SDPA yardstick (normalised output only: not the same
    function, and never called by the port)."""
    import torch.nn.functional as F
    from multiverso_tpu_torch.ops import attention
    kw = dict(scale=float(q.shape[-1] ** -0.5), causal=causal)
    return {
        "ms": cuda_ms(lambda: attention.flash_block_attn(q, k, v, **kw),
                      reps),
        "graph_ms": graph_ms(lambda: attention.flash_block_attn(q, k, v,
                                                                **kw),
                             reps=5, calls=5),
        "plain_ms": cuda_ms(lambda: attention.flash_block_attn_plain(
            q, k, v, **kw), reps),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), reps),
        "library": "scaled_dot_product_attention "
                   f"({sdpa_backend(q, k, v, causal)}, float32)"}


def check_attention_kernel(dev) -> dict:
    """B6 at the LM's eval shape (causal) and at the ring-step shapes
    (non-causal), timed; on inputs with NaN in the K and V rows that no
    query sees (the LM's widths with twice the keys), against the plain
    version on the clean inputs; then once each at a small shape: causal
    with offsets, fully masked, with a bias, bfloat16, D = 8 and D =
    256."""
    import torch
    from multiverso_tpu_torch.ops import attention

    g = torch.Generator(device=dev).manual_seed(8)

    def pair(what, q, k, v, bias=None, **kw):
        got = attention.flash_block_attn(q, k, v, bias, **kw)
        want = attention.flash_block_attn_plain(q, k, v, bias, **kw)
        return attn_compare(what, got, want), got, want

    b, h, s, dh = LM_BATCH, LM["heads"], LM["seq"], LM["dim"] // LM["heads"]
    q, k, v = attn_inputs(g, dev, b, h, s, s, dh)
    err, _, _ = pair(f"B6 at the LM's eval shape {(b, h, s, dh)}, causal",
                     q, k, v, scale=dh ** -0.5, causal=True, offsets=(0, 0))
    rec = time_attn(q, k, v, True, 20)
    bound = attn_bounds(b, h, s, s, dh, causal=True, offsets=(0, 0))
    log(f"B6 flash_block_attn {(b, h, s, dh)} causal: kernel "
        f"{rec['ms']:.4f} ms ({rec['graph_ms']:.4f} ms in a CUDA graph), "
        f"plain {rec['plain_ms']:.4f} ms, {rec['library']} "
        f"{rec['library_ms']:.4f} ms, {bounds_text(bound)}")
    # The kernel skips the k tiles that no query of its q tile sees, so
    # NaN there must not reach (o, m, l): keys s..2s-1 at offsets (0, 0).
    kp, vp = (torch.cat([t, torch.full_like(t, float("nan"))], dim=2)
              for t in (k, v))
    kc, vc = (torch.cat([t, t], dim=2) for t in (k, v))
    kw = dict(scale=dh ** -0.5, causal=True, offsets=(0, 0))
    poisoned = attn_compare(
        f"B6 at the LM's widths, keys {s}..{2 * s - 1} NaN (kernel) or "
        "clean (plain)", attention.flash_block_attn(q, kp, vp, **kw),
        attention.flash_block_attn_plain(q, kc, vc, **kw))
    del kp, vp, kc, vc
    shapes = []
    for b2, h2, s2, d2 in RING_SHAPES:
        q, k, v = attn_inputs(g, dev, b2, h2, s2, s2, d2)
        e, _, _ = pair(f"B6 ring step {(b2, h2, s2, d2)}", q, k, v,
                       scale=d2 ** -0.5)
        t = time_attn(q, k, v, False, 10)
        bd = attn_bounds(b2, h2, s2, s2, d2)
        log(f"B6 ring step {(b2, h2, s2, d2)} float32: kernel "
            f"{t['ms']:.4f} ms ({t['graph_ms']:.4f} ms in a CUDA graph), "
            f"plain {t['plain_ms']:.4f} ms, {t['library']} "
            f"{t['library_ms']:.4f} ms, {bounds_text(bd)}")
        shapes.append({"shape": [b2, h2, s2, d2], "causal": False,
                       "max_abs_err": e, **t, **bd})
        del q, k, v

    variants = [{"case": "NaN in the unseen keys' K and V, LM widths",
                 "max_abs_err": poisoned}]
    q, k, v = attn_inputs(g, dev, 2, 3, 128, 256, 64)
    for offs in ((0, 0), (384, 128), (128, 384)):
        e, _, _ = pair(f"B6 causal offsets {offs}", q, k, v, scale=0.125,
                       causal=True, offsets=offs)
        variants.append({"case": f"causal offsets {list(offs)}",
                         "max_abs_err": e})
    q, k, v = attn_inputs(g, dev, 2, 3, 128, 128, 64)
    full = torch.full((128, 128), attention.NEG_INF, device=dev)
    for case, kw in (("fully masked (causal)",
                      dict(causal=True, offsets=(0, 128))),
                     ("fully masked (bias)", dict(bias=full))):
        e, got, want = pair(f"B6 {case}", q, k, v, scale=0.125, **kw)
        assert bool((got[1] == attention.NEG_INF).all()), case
        assert torch.equal(got[2], want[2]), case
        variants.append({"case": case, "max_abs_err": e})
    q, k, v = attn_inputs(g, dev, 2, 3, 256, 384, 64)
    band = torch.where(torch.arange(384, device=dev)[None, :]
                       > torch.arange(256, device=dev)[:, None] + 100,
                       attention.NEG_INF, 0.0).to(torch.float32)
    e, _, _ = pair("B6 bias", q, k, v, band, scale=0.125)
    variants.append({"case": "bias", "max_abs_err": e})
    e, _, _ = pair("B6 bfloat16", *(t.to(torch.bfloat16) for t in (q, k, v)),
                   scale=0.125)
    variants.append({"case": "bfloat16", "max_abs_err": e})
    for d2 in (8, 256):
        q, k, v = attn_inputs(g, dev, 2, 3, 256, 384, d2)
        e, _, _ = pair(f"B6 D={d2} causal", q, k, v, scale=d2 ** -0.5,
                       causal=True, offsets=(128, 0))
        variants.append({"case": f"D={d2}", "max_abs_err": e})
    return {"name": "flash_block_attn", "route": "cuda",
            "source": "multiverso_tpu_torch/csrc/attention.cu",
            "replaces": "multiverso_tpu/ops/pallas_attention.py:97",
            "shape": [b, h, s, dh], "causal": True, "max_abs_err": err,
            **rec, **bound, "shapes": shapes, "variants": variants}


# ---------------------------------------------------------------------------
# phase 2 (B7): paged decode attention against its plain version
# ---------------------------------------------------------------------------
def decode_workload(rng, n_req: int, bucket: int, prefix_frac: float,
                    shared_prompt):
    """``scripts/serve_bench.py::_decode_workload`` (:571-587): a quarter
    of the prompts a long tail of 3/4 to all of ``bucket``, the rest a
    short head under a quarter of it; a ``prefix_frac`` fraction repeats
    ONE shared prompt."""
    prompts = []
    for _ in range(n_req):
        if prefix_frac > 0.0 and rng.random() < prefix_frac:
            prompts.append(list(shared_prompt))
        elif rng.random() < 0.25:               # the long tail
            n = int(rng.integers(max(bucket * 3 // 4, 2), bucket + 1))
            prompts.append(rng.integers(1, 60, n).tolist())
        else:                                    # the short head
            n = int(rng.integers(1, max(bucket // 4, 2)))
            prompts.append(rng.integers(1, 60, n).tolist())
    return prompts


def paged_inputs(g, dev, lengths, t, bucket, max_new, page, heads, dh,
                 n_phys, layers=1, dtype=None, scales=None):
    """B7's inputs as the serving step hands them: q [B, H, dh]; one
    layer (the middle one) of a ``[n_phys, layers, H, page, dh]`` pool,
    random; a page table from ``page_plan`` of each length, pages drawn
    in order from 1 (pad pages on the garbage page 0); lengths and t. For
    an int8 pool the random float pool is encoded by the serving codec
    (``serving/quant.encode_rows``, a scale a row), and ``scales`` (a
    dict) receives the layer's scale planes ``ks``/``vs``."""
    import torch
    from multiverso_tpu_torch.serving import page_plan, pages_of
    from multiverso_tpu_torch.serving.quant import encode_rows

    G = pages_of(bucket + max_new, page)
    ptab = torch.zeros((len(lengths), G), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(lengths):
        plan = page_plan(n, bucket, max_new, page)
        for logical in (*plan.shared, *plan.private):
            ptab[b, logical] = nxt
            nxt += 1
    assert nxt <= n_phys, (nxt, n_phys)
    shape = (n_phys, layers, heads, page, dh)
    dt = dtype or torch.float32
    kp = torch.randn(shape, generator=g, device=dev)
    vp = torch.randn(shape, generator=g, device=dev)
    i = layers // 2
    if dt == torch.int8:
        (kp, ks), (vp, vs) = encode_rows(kp, "int8"), encode_rows(vp, "int8")
        scales.update(ks=ks[:, i], vs=vs[:, i])
    else:
        kp, vp = kp.to(dt), vp.to(dt)
    q = torch.randn((len(lengths), heads, dh), generator=g, device=dev)
    return (q, kp[:, i], vp[:, i], ptab.to(dev),
            torch.as_tensor(lengths, dtype=torch.int32, device=dev),
            torch.as_tensor(t, dtype=torch.int32, device=dev))


def paged_bound(q, kp, ptab, lengths, t, bucket, page):
    """The bytes B7 must move for these inputs: the K and V row of each
    key a slot's mask admits (a masked key adds exactly 0, and each row
    is a contiguous dh-element line; an int8 row with its 4-byte float32
    scale), q read and o written, the page table entries of the pages
    holding admitted keys, lengths and t. The work, 4 dh flops per
    admitted key (2 more per element for int8's dequantization), is far
    below the bytes' time."""
    import numpy as np
    import torch
    B, H, dh = q.shape
    G = ptab.shape[1]
    lens, ts = lengths.cpu().numpy(), t.cpu().numpy()
    pages = keys = 0
    for b in range(B):
        pos = np.arange(G * page)
        valid = (pos < lens[b]) | ((pos >= bucket) & (pos <= bucket + ts[b]))
        pages += int(valid.reshape(G, page).any(axis=1).sum())
        keys += int(valid.sum())
    elem = kp.element_size()
    quant = kp.dtype == torch.int8
    row = dh * elem + (4 if quant else 0)
    n_bytes = (2 * keys * H * row + 2 * B * H * dh * 4
               + (pages + 2 * B) * 4)
    return bound_ms(n_bytes, (6.0 if quant else 4.0) * dh * keys * H)


PAGED_LONG_BUCKET = 2048   # B7's long-context shape: 8 full prompts

#: (head size, pool dtype) of one small B7 case per template instance of
#: ``csrc/paged_attention.cu``: the 16-byte vector instances (4 lanes a
#: key row, then 8 lanes with 1, 2, 4 or 8 vectors a lane), then the
#: narrow ones (rows not whole 16-byte vectors: 32 lanes a row with 1, 2,
#: 4 or 8 values a lane).
PAGED_INSTANCES = (
    (8, "float32"), (32, "float32"), (64, "float32"), (128, "float32"),
    (256, "float32"), (8, "bfloat16"), (64, "bfloat16"), (128, "bfloat16"),
    (256, "bfloat16"), (6, "float32"), (63, "float32"), (102, "float32"),
    (255, "float32"), (6, "bfloat16"), (60, "bfloat16"), (100, "bfloat16"),
    (250, "bfloat16"))


def paged_poisoned(args, bucket, page, scales=None):
    """``args`` with NaN in every K and V row of the physical pages that
    only wholly masked logical pages point at (the pages a kernel that
    reads only live pages skips), and their count. A logical page is
    wholly masked when the mask admits none of its positions; every slot
    must admit one, and no page may be both skipped and read. An int8
    pool's such pages get payloads of 127 (an int8 has no NaN) and NaN
    scales, the poisoned scale planes returned in ``scales``' place."""
    import numpy as np
    import torch
    q, kp, vp, ptab, lens, ts = args
    B, G = ptab.shape
    pos = np.arange(G * page)[None, :]
    lens_h, ts_h = lens.cpu().numpy()[:, None], ts.cpu().numpy()[:, None]
    admitted = (pos < lens_h) | ((pos >= bucket) & (pos <= bucket + ts_h))
    assert admitted.any(axis=1).all()
    live = torch.as_tensor(admitted.reshape(B, G, page).any(axis=2),
                           device=ptab.device)
    dead = torch.unique(ptab[~live].long())
    assert not bool(torch.isin(dead, ptab[live].long()).any())
    kn, vn = kp.clone(), vp.clone()
    poison = 127 if kp.dtype == torch.int8 else float("nan")
    kn[dead] = poison
    vn[dead] = poison
    if scales is not None:
        scales = {k: v.clone() for k, v in scales.items()}
        for v in scales.values():
            v[dead] = float("nan")
        return (q, kn, vn, ptab, lens, ts), int(dead.numel()), scales
    return (q, kn, vn, ptab, lens, ts), int(dead.numel())


def paged_shapes(dev, dtype=None, scales=None):
    """B7's two main-path shapes, one at a time: (what, bucket, args).
    The serving phase's shape (8 slots, 12 heads, dh 64, page 16, bucket
    512, max_new 64: G = 36) over one layer of a pool of the serving
    phase's size, a page table from real page plans of the serving
    workload's mixed lengths (one full prompt) and mixed t; then a
    long-context shape: 8 full prompts at bucket 2,048 (G = 132), one
    layer of a pool that holds them. ``dtype`` int8: the pools encoded by
    the serving codec, their scale planes into ``scales``."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.serving import default_pool_pages
    g = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.default_rng(7)
    S, N, P = SERVE_BUCKETS[-1], SERVE_MAX_NEW, SERVE_PAGE
    H, dh = LM["heads"], LM["dim"] // LM["heads"]
    lengths = [min(len(p), S) for p in decode_workload(
        rng, SERVE_BATCH, S, 0.0, [])]
    lengths[0] = S                        # one full prompt
    t = rng.integers(0, N, SERVE_BATCH).tolist()
    n_phys = default_pool_pages(SERVE_BUCKETS, SERVE_BATCH, N, P) + 1
    yield "at the serving shape", S, paged_inputs(
        g, dev, lengths, t, S, N, P, H, dh, n_phys, layers=LM["layers"],
        dtype=dtype, scales=scales)
    L = PAGED_LONG_BUCKET
    t = rng.integers(0, N, SERVE_BATCH).tolist()
    n_phys = SERVE_BATCH * -(-(L + N) // P) + 1
    yield "at the long-context shape", L, paged_inputs(
        g, dev, [L] * SERVE_BATCH, t, L, N, P, H, dh, n_phys,
        layers=LM["layers"], dtype=dtype, scales=scales)


def paged_yardstick(args, bucket, page):
    """SDPA over the cache gathered beforehand (the gather not timed),
    with the serving mask: B7's yardstick. Not the same function: it
    reads a contiguous cache, and the port never calls it."""
    import torch
    import torch.nn.functional as F
    q, kp, vp, ptab, lens, ts = args
    (B, G), (H, dh) = ptab.shape, q.shape[1:]
    idx = ptab.long().reshape(-1)
    kf = kp.index_select(0, idx).reshape(B, G, H, page, dh) \
        .transpose(1, 2).reshape(B, H, G * page, dh)
    vf = vp.index_select(0, idx).reshape(B, G, H, page, dh) \
        .transpose(1, 2).reshape(B, H, G * page, dh)
    pos = torch.arange(G * page, device=q.device)[None, :]
    mask = ((pos < lens[:, None]) | ((pos >= bucket)
                                     & (pos <= bucket + ts[:, None])))
    mask = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q[:, :, None], kf, vf,
                                                  attn_mask=mask)


def paged_pair(what, args, kw, want=None, counter="paged_decode_attn"):
    """B7 (the wrapper on the card) against its plain version within
    ``PAGED_TOL``: ``args`` and ``kw`` the wrapper's, ``want`` the plain
    version's ``(args, kw)`` where they differ (clean pages for a poisoned
    launch); the launch must count one on ``counter``. Returns the max
    abs error."""
    import torch
    from multiverso_tpu_torch.ops import attention
    before = attention.LAUNCHES[counter]
    got = attention.paged_decode_attn(*args, **kw)
    assert attention.LAUNCHES[counter] == before + 1, what
    want_args, want_kw = want or (args, kw)
    ref = attention.paged_decode_attn_plain(*want_args, **want_kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()), what
    err = float((got - ref).abs().max())
    ok = bool(((got - ref).abs() <= PAGED_TOL["atol"]
               + PAGED_TOL["rtol"] * ref.abs()).all())
    log(f"  {what}: max |kernel - plain| {err:.3e}")
    assert ok, (what, err)
    return err


def paged_repeatable(what, args, kw) -> None:
    """Two B7 launches bitwise equal, one on a side stream, and a CUDA
    graph replay equal to them."""
    import torch
    from multiverso_tpu_torch.ops import attention
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
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second), what
    assert torch.equal(captured, first), what
    log(f"  {what}: two launches bitwise equal, a graph replay equal "
        "to them")


def check_paged_kernel(dev) -> dict:
    """B7 at the serving phase's shape (8 slots, 12 heads, dh 64, page 16,
    bucket 512, max_new 64: G = 36 pages) over one layer of a pool of the
    serving phase's size, a page table from real page plans of the
    serving workload's mixed lengths and mixed t; and at a long-context
    shape (8 full prompts of 2,048, G = 132). Each is timed with events
    and in a CUDA graph, against the plain version and the SDPA
    yardstick, held against the plain version with NaN in every page the
    mask wholly excludes, and launched twice (bitwise equal) and from a
    CUDA graph (equal to the eager launch). Then small variants: a
    bfloat16 pool, a page that does not divide the bucket, an idle slot
    on the garbage page, t = 0, dh = 128, one case per template instance,
    a table of 604 pages of 1 row, and B x H that fills the card (one
    CTA a slot and head)."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.ops import attention

    g = torch.Generator(device=dev).manual_seed(10)
    rng = np.random.default_rng(8)
    S, N, P = SERVE_BUCKETS[-1], SERVE_MAX_NEW, SERVE_PAGE
    H, dh = LM["heads"], LM["dim"] // LM["heads"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def pair(what, args, page, bucket, scale, want_args=None):
        kw = dict(bucket=bucket, page=page, scale=scale)
        return paged_pair(what, args, kw,
                          want=(want_args, kw) if want_args else None)

    def shape(what, bucket, args):
        """Checks and times of B7 at one main-path shape."""
        G = args[3].shape[1]
        scale = dh ** -0.5
        kw = dict(bucket=bucket, page=P, scale=scale)
        err = pair(f"B7 {what} (B {SERVE_BATCH}, H {H}, dh {dh}, page {P}, "
                   f"bucket {bucket}, max_new {N}, G {G})", args, P, bucket,
                   scale)
        poisoned, n_dead = paged_poisoned(args, bucket, P)
        nan_err = pair(f"B7 {what}, NaN in the {n_dead} pages only wholly "
                       "masked logical pages point at", poisoned, P, bucket,
                       scale, want_args=args)
        del poisoned
        paged_repeatable(f"B7 {what}", args, kw)
        rec = {
            "ms": cuda_ms(lambda: attention.paged_decode_attn(*args, **kw),
                          50),
            "graph_ms": graph_ms(lambda: attention.paged_decode_attn(
                *args, **kw)),
            "plain_ms": cuda_ms(lambda: attention.paged_decode_attn_plain(
                *args, **kw), 50),
            "yardstick_ms": cuda_ms(paged_yardstick(args, bucket, P), 50)}
        q, kp, vp, ptab, lens, ts = args
        bound = paged_bound(q, kp, ptab, lens, ts, bucket, P)
        splits = attention.paged_splits(SERVE_BATCH * H, G, sms)
        log(f"B7 paged_decode_attn {what} ({SERVE_BATCH}, {H}, {dh}), page "
            f"{P}, G {G}, {splits} CTAs a slot and head: kernel "
            f"{rec['ms']:.4f} ms ({rec['graph_ms']:.4f} ms in a CUDA graph), "
            f"plain {rec['plain_ms']:.4f} ms, yardstick SDPA over the "
            f"pre-gathered cache {rec['yardstick_ms']:.4f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]})")
        return {"max_abs_err": err, "nan_excluded_pages_max_abs_err":
                nan_err, "pages_per_slot": G, "splits": splits, **rec,
                "bound_ms": bound[0], "bound_by": bound[1]}

    recs = []
    for what, bucket, args in paged_shapes(dev):
        recs.append(shape(what, bucket, args))
        del args
        torch.cuda.empty_cache()
    serving, long = recs

    variants = []
    small = dict(heads=4, n_phys=64)
    cases = [
        ("bfloat16 pool", [3, 60, 128, 17], [0, 5, 63, 20], 128, 64, 16, 64,
         torch.bfloat16),
        ("page 3 does not divide bucket 8", [3, 1, 8, 7], [0, 2, 5, 3], 8,
         6, 3, 64, None),
        ("idle slot on the garbage page", [1, 40, 100, 7], [0, 10, 63, 1],
         128, 64, 16, 64, None),
        ("t = 0", [5, 128, 64, 1], [0, 0, 0, 0], 128, 64, 16, 64, None),
        ("dh = 128", [3, 60, 128, 17], [0, 5, 63, 20], 128, 64, 16, 128,
         None)]
    for d, dt in PAGED_INSTANCES:
        cases.append((f"instance dh = {d}, {dt}", [3, 60, 128, 17],
                      [0, 5, 63, 20], 128, 64, 16, d, getattr(torch, dt)))
    for case, lens_v, t_v, bucket, mx, page, d, dt in cases:
        a = paged_inputs(g, dev, lens_v, t_v, bucket, mx, page,
                         small["heads"], d, small["n_phys"], dtype=dt)
        if case.startswith("idle"):
            a[3][0] = 0                     # every page the garbage page
        e = pair(f"B7 {case}", a, page, bucket, d ** -0.5)
        variants.append({"case": case, "max_abs_err": e})
    # A table longer than the kernel keeps in shared memory (512 entries):
    # page 1, G 604, the page-table row read from global memory.
    a = paged_inputs(g, dev, [3, 600, 17, 1], [0, 3, 2, 1], 600, 4, 1, 4,
                     64, 700)
    e = pair("B7 page 1, G 604 (the page-table row from global memory)", a,
             1, 600, 0.125)
    variants.append({"case": "page 1, G 604: the page-table row from "
                             "global memory", "max_abs_err": e})
    # B x H past PAGED_CTAS_PER_SM CTAs an SM: one CTA a slot and head.
    heads = 12
    slots = -(-attention.PAGED_CTAS_PER_SM * sms // heads)
    lens_v = rng.integers(1, 129, slots).tolist()
    t_v = rng.integers(0, 64, slots).tolist()
    a = paged_inputs(g, dev, lens_v, t_v, 128, 64, 16, heads, 64,
                     slots * 12 + 1)
    assert attention.paged_splits(slots * heads, 12, sms) == 1
    e = pair(f"B7 {slots} slots x {heads} heads (one CTA a slot and head)",
             a, 16, 128, 0.125)
    variants.append({"case": "B x H fills the card: one CTA a slot and "
                             "head", "max_abs_err": e})
    return {"name": "paged_decode_attn", "route": "cuda",
            "source": "multiverso_tpu_torch/csrc/paged_attention.cu",
            "replaces": "multiverso_tpu/ops/pallas_attention.py:253",
            "redesigned": "PR 9",
            "shape": [SERVE_BATCH, H, dh], "page": P, "bucket": S,
            **serving, "library_ms": None,
            "library": "none: no single PyTorch call reads through a page "
                       "table",
            "yardstick": "scaled_dot_product_attention over the cache "
                         "gathered beforehand, with the mask (float32; not "
                         "the same function, never called by the port)",
            "bitwise_repeat": True, "graph_equals_eager": True,
            "long_context": {"bucket": PAGED_LONG_BUCKET, **long},
            "variants": variants}


#: (head size) of one small case per template instance of B7's int8
#: pages: the 16-byte vector instances (16 int8 values a vector: 4 lanes a
#: key row with 1 vector, then 8 lanes with 1 or 2), then the narrow ones
#: (32 lanes a row with 1, 2, 4 or 8 values a lane).
PAGED_INT8_INSTANCES = (16, 64, 128, 256, 8, 60, 100, 250)


def check_paged_kernel_int8(dev) -> dict:
    """B7's int8 instance: int8 pages with their float32 scale planes
    (``ks``/``vs``, a scale a row), at the serving shape and the
    long-context shape of :func:`check_paged_kernel`, the pools encoded
    by the serving codec. Each is held against the plain int8 version
    (gather, ``payload.float() * scale``, softmax) within ``PAGED_TOL``,
    again with payloads of 127 and NaN scales in every page the mask
    wholly excludes (the plain version gets the clean pool), launched
    twice (bitwise equal) and from a CUDA graph (equal to the eager
    launch), and timed by events and in a graph beside the plain version
    and its byte bound (int8 rows: dh + 4 bytes). Then a page that does
    not divide the bucket, an idle slot on the garbage page, t = 0, and
    one small case per template instance."""
    import torch
    from multiverso_tpu_torch.ops import attention

    g = torch.Generator(device=dev).manual_seed(11)
    S, N, P = SERVE_BUCKETS[-1], SERVE_MAX_NEW, SERVE_PAGE
    H, dh = LM["heads"], LM["dim"] // LM["heads"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def pair(what, args, sc, page, bucket, scale, want=None):
        kw = dict(bucket=bucket, page=page, scale=scale)
        return paged_pair(what, args, {**kw, **sc},
                          want=want and (want[0], {**kw, **want[1]}),
                          counter="paged_decode_attn_int8")

    recs = []
    sc = {}
    for what, bucket, args in paged_shapes(dev, torch.int8, sc):
        G = args[3].shape[1]
        scale = dh ** -0.5
        kw = dict(bucket=bucket, page=P, scale=scale, **sc)
        label = (f"B7 int8 {what} (B {SERVE_BATCH}, H {H}, dh {dh}, page "
                 f"{P}, bucket {bucket}, max_new {N}, G {G})")
        err = pair(label, args, sc, P, bucket, scale)
        poisoned, n_dead, bad_sc = paged_poisoned(args, bucket, P, sc)
        nan_err = pair(f"B7 int8 {what}, payload 127 and NaN scales in the "
                       f"{n_dead} pages only wholly masked logical pages "
                       "point at", poisoned, bad_sc, P, bucket, scale,
                       want=(args, sc))
        del poisoned, bad_sc
        paged_repeatable(f"B7 int8 {what}", args, kw)
        rec = {
            "ms": cuda_ms(lambda: attention.paged_decode_attn(*args, **kw),
                          50),
            "graph_ms": graph_ms(lambda: attention.paged_decode_attn(
                *args, **kw)),
            "plain_ms": cuda_ms(lambda: attention.paged_decode_attn_plain(
                *args, **kw), 50)}
        q, kp, vp, ptab, lens, ts = args
        bound = paged_bound(q, kp, ptab, lens, ts, bucket, P)
        splits = attention.paged_splits(SERVE_BATCH * H, G, sms)
        log(f"B7 paged_decode_attn int8 {what} ({SERVE_BATCH}, {H}, {dh}), "
            f"page {P}, G {G}, {splits} CTAs a slot and head: kernel "
            f"{rec['ms']:.4f} ms ({rec['graph_ms']:.4f} ms in a CUDA graph), "
            f"plain {rec['plain_ms']:.4f} ms, bound {bound[0]:.4f} ms "
            f"({bound[1]})")
        recs.append({"max_abs_err": err, "nan_excluded_pages_max_abs_err":
                     nan_err, "pages_per_slot": G, "splits": splits, **rec,
                     "bound_ms": bound[0], "bound_by": bound[1]})
        del args, q, kp, vp
        sc.clear()
        torch.cuda.empty_cache()
    serving, long = recs

    variants = []
    cases = [("page 3 does not divide bucket 8", [3, 1, 8, 7], [0, 2, 5, 3],
              8, 6, 3, 64),
             ("idle slot on the garbage page", [1, 40, 100, 7],
              [0, 10, 63, 1], 128, 64, 16, 64),
             ("t = 0", [5, 128, 64, 1], [0, 0, 0, 0], 128, 64, 16, 64)]
    for d in PAGED_INT8_INSTANCES:
        cases.append((f"instance dh = {d}", [3, 60, 128, 17],
                      [0, 5, 63, 20], 128, 64, 16, d))
    for case, lens_v, t_v, bucket, mx, page, d in cases:
        a = paged_inputs(g, dev, lens_v, t_v, bucket, mx, page, 4, d, 64,
                         dtype=torch.int8, scales=sc)
        if case.startswith("idle"):
            a[3][0] = 0                     # every page the garbage page
        e = pair(f"B7 int8 {case}", a, sc, page, bucket, d ** -0.5)
        variants.append({"case": case, "max_abs_err": e})
        sc.clear()
    return {"name": "paged_decode_attn_int8", "route": "cuda",
            "source": "multiverso_tpu_torch/csrc/paged_attention.cu",
            "replaces": "multiverso_tpu/ops/pallas_attention.py:253",
            "dequantizes_as": "multiverso_tpu/serving/quant.py:94 "
                              "(decode_rows, after the JAX step's gather)",
            "instance_of": "paged_decode_attn",
            "shape": [SERVE_BATCH, H, dh], "page": P, "bucket": S,
            **serving, "library_ms": None,
            "library": "none: no single PyTorch call reads int8 pages "
                       "through a page table",
            "bitwise_repeat": True, "graph_equals_eager": True,
            "long_context": {"bucket": PAGED_LONG_BUCKET, **long},
            "variants": variants}


# ---------------------------------------------------------------------------
# phase 3: the table plane
# ---------------------------------------------------------------------------
def table_plane() -> None:
    import numpy as np
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core.options import AddOption
    from multiverso_tpu_torch.ops import rows

    rng = np.random.default_rng(1)
    n = ROWS // 10
    for updater, sign in (("default", 1.0), ("sgd", -1.0)):
        t = mv.create_table(mv.MatrixTableOption(
            ROWS, COLS, use_pallas=True, updater=updater,
            name=f"perf_{updater}"))
        assert t.store._pallas_rows and t.store.device.type == "cuda"
        expected = np.zeros((ROWS, COLS), np.float32)
        replay = torch.zeros((ROWS, COLS))
        for _ in range(3):
            ids = rng.integers(0, ROWS, size=n).astype(np.int32)
            deltas = rng.normal(size=(n, COLS)).astype(np.float32)
            t.add_rows(ids, deltas)
            np.add.at(expected, ids, sign * deltas)
            rows.scatter_add_rows(replay, torch.as_tensor(ids),
                                  torch.as_tensor(deltas), sign=sign)
        probe = rng.integers(0, ROWS, size=n).astype(np.int32)
        got = t.get_rows(probe)
        np.testing.assert_allclose(got, expected[probe], rtol=1e-5,
                                   atol=1e-5)
        assert np.array_equal(got, replay.numpy()[probe]), \
            f"{updater}: card rows differ from the CPU plain replay"
        assert np.array_equal(t.get(), replay.numpy())
        log(f"table plane [{updater}]: 3 x {n} row Adds + {n} row Gets "
            f"match the numpy replay (rtol 1e-5) and the CPU plain replay "
            f"(bitwise)")
    # Updates/sec on device-resident operands (bench.py's matrix sweep).
    store = t.store
    opt = AddOption()
    sets = [torch.randint(0, ROWS, (n,), device=store.device,
                          dtype=torch.int32) for _ in range(10)]
    delta = torch.ones((n, COLS), device=store.device)
    store.apply_rows(sets[0], delta, opt)
    store.block()
    t0 = time.perf_counter()
    for ids in sets:
        store.apply_rows(ids, delta, opt)
    store.block()
    dt = time.perf_counter() - t0
    log(f"table plane: {len(sets)} x {n} row Adds in {dt:.4f} s -> "
        f"{len(sets) * n * COLS / dt:.6g} param updates/sec "
        f"(sgd table, ids and deltas on the card)")
    t0 = time.perf_counter()
    got = t.get_rows(rng.integers(0, ROWS, size=n).astype(np.int32))
    dt = time.perf_counter() - t0
    log(f"table plane: get_rows of {n} rows (to host) in {dt * 1e3:.3f} ms")


def stateful_model(name, batches, opt, shape):
    """The updater in float64 numpy over the Adds ``batches`` from a zero
    table and zero state: duplicates summed, then the update on each
    touched row. Returns {"data": ..., "state/<leaf>": ...}."""
    import numpy as np
    f = [float(x) for x in opt[1:5]]        # momentum, lr, rho, lambda_
    out = {"data": np.zeros(shape)}
    leaves = {"momentum_sgd": ("smooth",), "adagrad": ("g2",),
              "ftrl": ("z", "n")}[name]
    for key in leaves:
        out[f"state/{key}"] = np.zeros(shape)
    for ids, deltas in batches:
        uniq, inv = np.unique(ids, return_inverse=True)
        g = np.zeros((len(uniq), shape[1]))
        np.add.at(g, inv, deltas.astype(np.float64))
        w = out["data"][uniq]
        if name == "momentum_sgd":
            s = f[0] * out["state/smooth"][uniq] + (1 - f[0]) * g
            out["state/smooth"][uniq] = s
            out["data"][uniq] = w - s
        elif name == "adagrad":
            gg = g / f[1]
            g2 = out["state/g2"][uniq] + gg * gg
            out["state/g2"][uniq] = g2
            out["data"][uniq] = w - f[2] / np.sqrt(g2 + 1e-6) * gg
        else:
            l2, alpha, beta, l1 = f
            n = out["state/n"][uniq]
            n_new = n + g * g
            z = (out["state/z"][uniq] + g
                 - (np.sqrt(n_new) - np.sqrt(n)) / alpha * w)
            out["data"][uniq] = np.where(
                np.abs(z) > l1, -(z - np.sign(z) * l1) /
                ((beta + np.sqrt(n_new)) / alpha + l2), 0.0)
            out["state/z"][uniq] = z
            out["state/n"][uniq] = n_new
    if name == "adagrad":                     # [num_workers=1, R, D]
        out["state/g2"] = out["state/g2"][None]
    return out


def stateful_table_plane(name) -> dict:
    """One stateful ``use_pallas`` table on the card through the user's
    calls: 3 row Adds of 100,000 ids (with duplicates) and row Gets,
    bitwise against the same Adds replayed through the port's plain path
    on the CPU (data and every state leaf) and close to a float64 numpy
    model; then param updates/sec on device-resident operands."""
    import numpy as np
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core.options import AddOption
    from multiverso_tpu_torch.core.table import ServerStore
    from multiverso_tpu_torch.core.updater import get_updater

    rng = np.random.default_rng(7)
    n = ROWS // 10
    opt = AddOption(**STATEFUL_OPT)
    t = mv.create_table(mv.MatrixTableOption(ROWS, COLS, use_pallas=True,
                                             updater=name,
                                             name=f"stateful_{name}"))
    store = t.store
    assert store._pallas_cap == "fused_stateful", store._pallas_cap
    assert store.device.type == "cuda", store.device
    replay = ServerStore(f"replay_{name}", (ROWS, COLS), np.float32,
                         get_updater(np.float32, name), torch.device("cpu"),
                         num_workers=1, use_pallas_rows=True)
    batches = []
    for _ in range(3):
        ids = rng.integers(0, ROWS, size=n).astype(np.int32)
        deltas = rng.normal(size=(n, COLS)).astype(np.float32)
        t.add_rows(ids, deltas, opt)
        replay.apply_rows(ids, deltas, opt)
        batches.append((ids, deltas))
    probe = rng.integers(0, ROWS, size=n).astype(np.int32)
    assert np.array_equal(t.get_rows(probe),
                          replay.read_rows(probe).numpy()), name
    got, want = store.store_state(), replay.store_state()
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for key in want:
        assert np.array_equal(got[key], want[key]), \
            f"{name}: card {key} differs from the CPU plain replay"
    del replay, want
    model = stateful_model(name, batches, opt.scalars(), (ROWS, COLS))
    worst = {}
    for key, ref in model.items():
        err = np.abs(got[key] - ref)
        worst[key] = float(err.max())
        assert bool((err <= MODEL_ATOL + MODEL_RTOL * np.abs(ref)).all()), \
            (name, key, worst[key])
    del got, model
    log(f"stateful table plane [{name}]: 3 x {n} row Adds + {n} row Gets "
        f"bitwise to the CPU plain replay (data and "
        f"{', '.join(sorted(store.state))}); against the float64 model "
        f"max |err| " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (limit {MODEL_ATOL} + {MODEL_RTOL} |model|)")
    # Updates/sec on device-resident operands, as the sgd line.
    sets = [torch.randint(0, ROWS, (n,), device=store.device,
                          dtype=torch.int32) for _ in range(10)]
    delta = torch.randn((n, COLS), device=store.device)
    store.apply_rows(sets[0], delta, opt)
    store.block()
    t0 = time.perf_counter()
    for ids in sets:
        store.apply_rows(ids, delta, opt)
    store.block()
    dt = time.perf_counter() - t0
    rate = len(sets) * n * COLS / dt
    log(f"stateful table plane [{name}]: {len(sets)} x {n} row Adds in "
        f"{dt:.4f} s -> {rate:.6g} param updates/sec (ids and deltas on "
        f"the card)")
    return {"updater": name, "updates_per_sec": rate,
            "model_max_abs_err": worst}


def stateful_add_kernels() -> list:
    """The device work of one stateful row Add of a ``use_pallas`` adagrad
    table (100,000 ids into 1,000,000 x 50), traced by ``torch.profiler``:
    the stable sort's kernels and exactly one launch of the fused kernel;
    no fold, no gather of the deltas (``index_select``). Returns the
    names."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.core.options import AddOption
    from multiverso_tpu_torch.core.table import ServerStore
    from multiverso_tpu_torch.core.updater import get_updater

    dev = torch.device("cuda", 0)
    store = ServerStore("kernels_adagrad", (ROWS, COLS), np.float32,
                        get_updater(np.float32, "adagrad"), dev,
                        num_workers=1, use_pallas_rows=True)
    g = torch.Generator(device=dev).manual_seed(10)
    ids = torch.randint(0, ROWS, (N_IDS,), generator=g, device=dev)
    deltas = torch.randn((N_IDS, COLS), generator=g, device=dev)
    opt = AddOption(**STATEFUL_OPT)
    store.apply_rows(ids, deltas, opt)
    names = kernels_launched(lambda: store.apply_rows(ids, deltas, opt))
    assert names, "torch.profiler recorded no device activity"
    fused = [n for n in names if "stateful_runs_kernel" in n]
    assert len(fused) == 1, names
    assert not any(key in n.lower() for n in names
                   for key in ("fold_runs", "indexselect", "index_select")), \
        names
    short = [n.split("::", 1)[-1].split("(")[0][:60] for n in names]
    log(f"one stateful row Add (adagrad, use_pallas) starts {len(names)} "
        f"device activities, the fused kernel once and no fold or gather "
        f"of the deltas (torch.profiler): {short}")
    return names


def plain_tables() -> dict:
    """Tables without the row kernels (``use_pallas`` off, the default) on
    the card, through the user's calls: float32 tables with the default,
    sgd, adagrad and dcasgd updaters, 3 row Adds each of 100,000 ids with
    duplicates (a run of 64 equal ids in each) and out-of-range ids, bitwise
    against the same Adds replayed on the CPU. Default and sgd add each
    row's duplicates in lane order by a stable sort and B4 (ROADMAP C4:
    never index_add_'s float atomics); adagrad and dcasgd combine them by
    the fold. Returns {updater: {"launches": ...}}."""
    import numpy as np
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core.options import AddOption
    from multiverso_tpu_torch.core.table import ServerStore
    from multiverso_tpu_torch.core.updater import get_updater
    from multiverso_tpu_torch.ops import rows

    rng = np.random.default_rng(9)
    n = ROWS // 10
    opt = AddOption(**STATEFUL_OPT)
    out = {}
    for name in ("default", "sgd", "adagrad", "dcasgd"):
        before = dict(rows.LAUNCHES)
        t = mv.create_table(mv.MatrixTableOption(ROWS, COLS, updater=name,
                                                 name=f"plain_{name}"))
        assert not t.store._pallas_rows and t.store.device.type == "cuda"
        replay = ServerStore(f"replay_plain_{name}", (ROWS, COLS),
                             np.float32, get_updater(np.float32, name),
                             torch.device("cpu"), num_workers=1)
        for _ in range(3):
            ids = rng.integers(0, ROWS, size=n)
            ids[rng.permutation(n)[:64]] = ids[0]
            ids[rng.permutation(n)[:8]] = ROWS + 3
            deltas = rng.normal(size=(n, COLS)).astype(np.float32)
            t.add_rows(ids, deltas, opt)
            replay.apply_rows(ids, deltas, opt)
        got, want = t.store.store_state(), replay.store_state()
        for key in want:
            assert np.array_equal(got[key].view(np.uint32),
                                  want[key].view(np.uint32)), \
                f"{name}: card {key} differs from the CPU replay"
        launched = {k: rows.LAUNCHES[k] - before[k] for k in rows.LAUNCHES}
        kernel = ("tiled_scatter_add_sorted_rows"
                  if name in ("default", "sgd") else "fold_sorted_runs")
        assert launched[kernel] == 3, (name, launched)
        log(f"plain table [{name}] (no row kernels): 3 x {n} row Adds with "
            f"duplicates and out-of-range ids bitwise to the CPU replay "
            f"({', '.join(sorted(want))}); {kernel} launched 3 times")
        out[name] = {"launches": launched}
        del t, replay, got, want
    return out


def tiled_leg(dev) -> float:
    """bench.py's row scatter leg (bench.py:434-480) through B4: 8,192
    sorted ids (bench.py's draw) of ones into a zero 100,000 x 128 table,
    21 calls of ``tiled_scatter_add_rows``; every row must then hold 21
    times its id's count, exactly. Returns ms per call."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.ops import rows

    rng = np.random.default_rng(2)
    ids_np = np.sort(rng.integers(0, B4_ROWS, size=B4_IDS)).astype(np.int32)
    table = torch.zeros((B4_ROWS, B4_COLS), device=dev)
    ids = torch.as_tensor(ids_np, device=dev)
    deltas = torch.ones((B4_IDS, B4_COLS), device=dev)
    rows.tiled_scatter_add_rows(table, ids, deltas)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        rows.tiled_scatter_add_rows(table, ids, deltas)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 20 * 1e3
    want = 21 * np.bincount(ids_np, minlength=B4_ROWS).astype(np.float32)
    assert np.array_equal(table.cpu().numpy(),
                          np.repeat(want[:, None], B4_COLS, 1))
    log(f"B4 leg (bench.py's row scatter): 21 x tiled_scatter_add_rows of "
        f"{B4_IDS} x {B4_COLS} into {B4_ROWS} x {B4_COLS}, exact counts, "
        f"{ms:.4f} ms per call (host clock, sort included)")
    return ms


def bf16_table_plane() -> dict:
    """A 1,000,000 x 50 bfloat16 table with the default updater through
    the user's calls: 10 row Adds of 100,000 ids (natural duplicates and a
    run of 64 equal ids in each), bitwise against the same Adds replayed
    on the CPU (each row's duplicates folded in lane order with a rounding
    after every add, XLA's scatter order), and row Gets."""
    import numpy as np
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core.options import AddOption
    from multiverso_tpu_torch.core.table import ServerStore
    from multiverso_tpu_torch.core.updater import get_updater

    rng = np.random.default_rng(8)
    n = ROWS // 10
    t = mv.create_table(mv.MatrixTableOption(ROWS, COLS, dtype="bfloat16",
                                             updater="default",
                                             name="bf16_default"))
    assert t.store.data.dtype == torch.bfloat16 and \
        t.store.device.type == "cuda"
    replay = ServerStore("replay_bf16", (ROWS, COLS), "bfloat16",
                         get_updater("bfloat16", "default"),
                         torch.device("cpu"), num_workers=1)
    batches = []
    for _ in range(10):
        ids = rng.integers(0, ROWS, size=n).astype(np.int32)
        ids[rng.permutation(n)[:64]] = ids[0]
        batches.append((ids, (0.01 * rng.normal(size=(n, COLS))
                              ).astype(np.float32)))
    t.add_rows(*batches[0])                      # the first one untimed
    replay.apply_rows(*batches[0], AddOption())
    t.store.block()
    t0 = time.perf_counter()
    for ids, deltas in batches[1:]:
        t.add_rows(ids, deltas)
    t.store.block()
    dt = time.perf_counter() - t0
    for ids, deltas in batches[1:]:
        replay.apply_rows(ids, deltas, AddOption())
    assert torch.equal(t.store.data.cpu().view(torch.int16),
                       replay.data.view(torch.int16)), \
        "bf16 table: card differs from the CPU replay"
    probe = rng.integers(0, ROWS, size=n).astype(np.int32)
    got = t.get_rows(probe)
    assert got.dtype == np.float32
    assert np.array_equal(got, replay.read_rows(probe).float().numpy())
    rate = 9 * n * COLS / dt
    log(f"bf16 table plane [default]: 10 x {n} row Adds (a run of 64 equal "
        f"ids in each) + {n} row Gets bitwise to the CPU replay; 9 Adds in "
        f"{dt:.4f} s -> {rate:.6g} param updates/sec (host numpy ids and "
        f"deltas, as the user passes them)")
    return {"updates_per_sec": rate}


#: The stateful updaters a bfloat16 table runs (ROADMAP A13).
BF16_STATEFUL = ("momentum_sgd", "adagrad", "ftrl", "dcasgd", "dcasgda")


def replay_equal(name, card_store, cpu_store) -> list:
    """The card store's ``store_state()`` bitwise the CPU replay's (data
    and every state leaf, uint32 views: a bfloat16 table's payload widens
    exactly); returns the keys."""
    import numpy as np
    got, want = card_store.store_state(), cpu_store.store_state()
    assert sorted(got) == sorted(want), (name, sorted(got), sorted(want))
    for key in want:
        assert got[key].dtype == want[key].dtype, (name, key)
        assert np.array_equal(got[key].view(np.uint32),
                              want[key].view(np.uint32)), \
            f"{name}: card {key} differs from the CPU replay"
    return sorted(want)


def bf16_stateful_tables() -> dict:
    """A13 on the card: a 1,000,000 x 50 bfloat16 table for each stateful
    updater, through the user's calls: 3 row Adds of 100,000 ids with
    duplicates (a run of 64 equal ids in each) and one dense Add, with
    non-default option scalars, bitwise against the same Adds replayed
    through the port on the CPU, data and every state leaf (each leaf in
    the dtype the JAX ``init_state`` gives it). The duplicate combine
    folds bfloat16 deltas in lane order with a rounding after every add
    (``ops/rows.fold_runs_lane_order``: a sort and index ops, no float
    atomics); the fold kernel and the fused route are never launched (the
    row kernels take float32 tables only, as in the JAX package). Returns
    {updater: {"leaves": ..., "updates_per_sec": ...}}."""
    import numpy as np
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core.options import AddOption
    from multiverso_tpu_torch.core.table import ServerStore
    from multiverso_tpu_torch.core.updater import get_updater
    from multiverso_tpu_torch.ops import rows

    rng = np.random.default_rng(12)
    n = ROWS // 10
    opt = AddOption(**STATEFUL_OPT)
    out = {}
    for name in BF16_STATEFUL:
        before = dict(rows.LAUNCHES)
        t = mv.create_table(mv.MatrixTableOption(
            ROWS, COLS, dtype="bfloat16", updater=name, use_pallas=True,
            name=f"bf16_{name}"))
        assert t.store.data.dtype == torch.bfloat16 and \
            t.store.device.type == "cuda" and not t.store._pallas_rows
        replay = ServerStore(f"replay_bf16_{name}", (ROWS, COLS),
                             "bfloat16", get_updater("bfloat16", name),
                             torch.device("cpu"), num_workers=1)
        batches = []
        for _ in range(3):
            ids = rng.integers(0, ROWS, size=n)
            ids[rng.permutation(n)[:64]] = ids[0]
            batches.append((ids, (0.1 * rng.normal(size=(n, COLS)))
                            .astype(np.float32)))
        t.store.block()
        t0 = time.perf_counter()
        for ids, deltas in batches:
            t.add_rows(ids, deltas, opt)
        t.store.block()
        dt = time.perf_counter() - t0
        for ids, deltas in batches:
            replay.apply_rows(ids, deltas, opt)
        dense = (0.01 * rng.normal(size=(ROWS, COLS))).astype(np.float32)
        t.add(dense, opt)
        replay.apply_dense(dense, opt)
        leaves = replay_equal(f"bf16 {name}", t.store, replay)
        launched = {k: rows.LAUNCHES[k] - before[k] for k in rows.LAUNCHES}
        for k in ("fold_sorted_runs", "fused_stateful_sorted_rows",
                  "fused_stateful_rows", "scatter_add_sorted_rows"):
            assert launched[k] == 0, (name, launched)
        rate = 3 * n * COLS / dt
        # (the first Add of each table is in the timed window: the rate is
        # of a cold table, host numpy ids and deltas, as the user passes)
        dtypes = {k: str(v.dtype).replace("torch.", "")
                  for k, v in t.store.state.items()}
        log(f"bf16 stateful table [{name}]: 3 x {n} row Adds (a run of 64 "
            f"equal ids in each) and a dense Add bitwise to the CPU replay "
            f"({', '.join(leaves)}; leaves {dtypes}); no fold or fused "
            f"launch; 3 Adds in {dt:.4f} s -> {rate:.6g} param updates/sec")
        out[name] = {"leaves": dtypes, "updates_per_sec": rate}
        del t, replay
        torch.cuda.empty_cache()
    return out


def negative_id_tables() -> dict:
    """ROADMAP C5 on the card: one 1,000,000 x 50 table on each route of
    a row Add, 100,000 ids with negative ones (in [-rows, 0), below
    -rows) and ids past the end, bitwise against the same Add replayed on
    the CPU: a float32 default table without the row kernels (negative
    ids wrap to the table's end, as JAX's ``.at[].add``), a ``use_pallas``
    sgd table (B2: dropped), a ``use_pallas`` adagrad table (the fused
    route: dropped), a dcasgd and a bfloat16 momentum_sgd table (the plain
    stateful route: dropped); then Gets with negative ids (clamped, -1 to
    row 0) through B1 and without it."""
    import numpy as np
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core.options import AddOption
    from multiverso_tpu_torch.core.table import ServerStore
    from multiverso_tpu_torch.core.updater import get_updater

    rng = np.random.default_rng(13)
    n = ROWS // 10
    opt = AddOption(**STATEFUL_OPT)
    routes = (("default", "float32", False, "wrap"),
              ("sgd", "float32", True, "drop (B2)"),
              ("adagrad", "float32", True, "drop (fused route)"),
              ("dcasgd", "float32", False, "drop (plain stateful)"),
              ("momentum_sgd", "bfloat16", False, "drop (plain stateful)"))
    out = {}
    for name, dtype, pallas, rule in routes:
        t = mv.create_table(mv.MatrixTableOption(
            ROWS, COLS, dtype=dtype, updater=name, use_pallas=pallas,
            name=f"neg_{name}"))
        replay = ServerStore(f"replay_neg_{name}", (ROWS, COLS), dtype,
                             get_updater(dtype, name), torch.device("cpu"),
                             num_workers=1, use_pallas_rows=pallas)
        ids = rng.integers(0, ROWS, size=n)
        ids[rng.permutation(n)[:64]] = ids[0]
        neg = rng.permutation(n)[:2_000]
        ids[neg[:1_000]] = -rng.integers(1, ROWS + 1, 1_000)
        ids[neg[1_000:1_500]] = -ROWS - rng.integers(1, 100, 500)
        ids[neg[1_500:]] = ROWS + rng.integers(0, 100, 500)
        ids[neg[0]] = -1
        deltas = (0.1 * rng.normal(size=(n, COLS))).astype(np.float32)
        t.add_rows(ids, deltas, opt)
        replay.apply_rows(ids, deltas, opt)
        replay_equal(f"negative ids {name}", t.store, replay)
        out[name] = {"dtype": dtype, "use_pallas": pallas, "rule": rule}
        log(f"negative ids [{name}, {dtype}, use_pallas={pallas}]: {n} row "
            f"ids, 1,500 of them negative, bitwise to the CPU replay "
            f"({rule})")
        if name in ("default", "sgd"):
            probe = np.concatenate([[-1, -ROWS, -ROWS - 5, ROWS + 2],
                                    ids[:1_000]])
            got = t.get_rows(probe)
            assert np.array_equal(got, replay.read_rows(probe)
                                  .float().numpy()), name
            assert np.array_equal(got[0], got[1]) and \
                np.array_equal(got[0], t.get_rows([0])[0])
            log(f"  Gets of {len(probe)} ids with negative ones "
                f"({'B1' if pallas else 'index_select'}): bitwise the CPU, "
                "-1 read as row 0")
        del t, replay
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4: the flagship
# ---------------------------------------------------------------------------
def flagship(sents, d, param_dtype: str = "float32",
             compact: bool = True) -> dict:
    """bench.py's word2vec leg through ``Word2Vec.train`` (AUTO: the B5
    kernel of the embeddings' dtype): a warm-up block, then 3 blocks, B5
    launched once per block and a finite loss."""
    import math
    from multiverso_tpu_torch.models.word2vec import Word2Vec
    from multiverso_tpu_torch.ops import sgns

    key = "sgns_block_bf16" if param_dtype == "bfloat16" else "sgns_block"
    w2v = Word2Vec(flagship_config(param_dtype, compact), d)
    assert w2v.dispatch_mode == "pallas_grid", w2v.dispatch_mode
    w2v.train(sentences=sents[:512])            # warm-up block
    w2v.trained_words = 0
    for k in sgns.LAUNCHES:
        sgns.LAUNCHES[k] = 0
    stats = w2v.train(sentences=sents[512:512 * 4])
    launches = dict(sgns.LAUNCHES)
    assert stats["blocks"] == 3, stats
    assert launches[key] == stats["blocks"], (launches, stats["blocks"])
    assert sum(launches.values()) == launches[key], launches
    assert math.isfinite(stats["loss"]), stats
    log(f"flagship word2vec {param_dtype}{'' if compact else ' uncompacted'}"
        f" (V={V}, D={D}, window 5, negative {NEG}, chunk {CHUNK}, adagrad, "
        f"pallas_grid): {stats['words']} words, {stats['pairs']} pairs in "
        f"{stats['seconds']:.4f} s -> {stats['words_per_sec']:.6g} "
        f"words/sec, {stats['pairs'] / stats['seconds']:.6g} pairs/sec, loss "
        f"{stats['loss']:.4f}, {key} launches {launches[key]}")
    return dict(stats, launches=launches[key])


def other_paths(sents, d) -> dict:
    """The flagship's other single-process paths at bench width (widths of
    bench.py's config, the same corpus): one block each of sg-hs, cbow-ns
    and cbow-hs on the device pipeline (the plain block step: the JAX
    package has no kernel for them), and the host batch path
    (``device_pipeline=False``) over 512 sentences; each a finite loss
    and no B5 launch. Returns {path: stats}."""
    import math
    from multiverso_tpu_torch.models.word2vec import Word2Vec
    from multiverso_tpu_torch.ops import sgns

    legs = {"sg-hs": dict(hs=True), "cbow-ns": dict(sg=False),
            "cbow-hs": dict(sg=False, hs=True),
            "host sg-ns": dict(device_pipeline=False)}
    out = {}
    for name, over in legs.items():
        for k in sgns.LAUNCHES:
            sgns.LAUNCHES[k] = 0
        w2v = Word2Vec(flagship_config(**over), d)
        stats = w2v.train(sentences=sents[:512])
        assert math.isfinite(stats["loss"]) and stats["pairs"] > 0, \
            (name, stats)
        assert sum(sgns.LAUNCHES.values()) == 0, (name, sgns.LAUNCHES)
        assert w2v.dispatch_mode == (None if "host" in name
                                     else "in_graph"), w2v.dispatch_mode
        log(f"word2vec {name} at bench width ("
            f"{w2v.dispatch_mode or 'host batch path'}, one block of 512 "
            f"sentences): {stats['words']} words, {stats['pairs']} "
            f"examples in {stats['seconds']:.4f} s -> "
            f"{stats['words_per_sec']:.6g} words/sec, loss "
            f"{stats['loss']:.4f}, no B5 launch")
        out[name] = stats
    return out


# ---------------------------------------------------------------------------
# phase 5: the CLI
# ---------------------------------------------------------------------------
def cli_topics(flags=(), mode: str = "pallas_grid") -> None:
    """The CLI on a two-topic corpus (``flags`` added; ``mode`` the
    chunk-loop mode it must report)."""
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        vectors = os.path.join(tmp, "vectors.txt")
        rng = np.random.default_rng(0)
        with open(corpus, "w") as f:
            for i in range(300):
                topic = "a" if i % 2 == 0 else "b"
                f.write(" ".join(f"{topic}{rng.integers(0, 5)}"
                                 for _ in range(12)) + "\n")
        cmd = [sys.executable, "-m", "multiverso_tpu_torch.apps.word2vec_main",
               f"-train_file={corpus}", f"-output_file={vectors}",
               "-size=128", "-sample=0", "-min_count=1", "-epoch=3",
               "-batch_size=512", "-block_sentences=64",
               "-pad_sentence_length=16", *flags]
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        tail = "\n".join(proc.stdout.splitlines()[-4:])
        assert proc.returncode == 0, (proc.returncode, proc.stdout[-3000:],
                                      proc.stderr[-3000:])
        with open(vectors) as f:
            v, dim = map(int, f.readline().split())
            rows = [line.split() for line in f]
        assert (v, dim) == (10, 128) and len(rows) == v, (v, dim, len(rows))
        emb = {r[0]: np.asarray(r[1:], np.float32) for r in rows}
        for k in emb:
            emb[k] /= np.linalg.norm(emb[k]) + 1e-12
        a = [w for w in emb if w.startswith("a")]
        b = [w for w in emb if w.startswith("b")]
        intra = np.mean([emb[x] @ emb[y] for x in a for y in a if x != y])
        inter = np.mean([emb[x] @ emb[y] for x in a for y in b])
        assert mode in proc.stdout and "cuda" in proc.stdout, tail
        log(f"CLI word2vec_main {' '.join(flags)} on the card ({mode}): "
            f"intra-topic cosine {intra:.4f}, cross-topic {inter:.4f}")
        assert intra > inter + 0.1, (intra, inter)


# ---------------------------------------------------------------------------
# phase 6: the attention LM
# ---------------------------------------------------------------------------
def cyclic_batches(n, b, s, k, seed=0):
    """Deterministic cyclic sequences, token[t+1] = (token[t] + 1) mod k
    (``tests/test_attention_lm.py:12-19``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [((rng.integers(0, k, size=(b, 1)) + np.arange(s)[None, :]) % k)
            .astype(np.int32) for _ in range(n)]


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def small_lm_against_cpu(dev) -> None:
    """A small LM on the card against the same parameters on the CPU
    (both drawn from the CPU generator of ``cfg.seed``): the loss with
    ``-flash_attention`` off and on (B6 at D = 8), and 2 ``fit`` steps."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.models.attention_lm import AttentionLM, LMConfig
    from multiverso_tpu_torch.utils.configure import set_flag

    cfg = dict(vocab=61, dim=32, heads=4, layers=2, seq=256)
    card = AttentionLM(LMConfig(**cfg), dev)
    host = AttentionLM(LMConfig(**cfg), torch.device("cpu"))
    for name, p in card.params.items():
        assert torch.equal(p.cpu(), host.params[name]), name
    batches = cyclic_batches(3, 4, cfg["seq"], cfg["vocab"], seed=3)
    ref = host.loss(batches[0])
    for flash in (False, True):
        set_flag("flash_attention", flash)
        got = card.loss(batches[0])
        log(f"small LM on the card, flash {flash}: loss {got} vs CPU {ref}")
        assert abs(got - ref) <= LM_LOSS_RTOL * abs(ref), (flash, got, ref)
    set_flag("flash_attention", False)
    got, want = card.fit(batches[1:]), host.fit(batches[1:])
    log(f"small LM on the card: 2 fit steps {got} vs CPU {want}")
    np.testing.assert_allclose(got, want, rtol=1e-4)


def attention_lm(dev, card) -> dict:
    """The LM at GPT-2-small widths on the card (see the module's
    docstring). Each run sets B6's count to 0 just before it and reads it
    just after; returns the readings and the sum of the counts."""
    import math
    import torch
    from multiverso_tpu_torch.models.attention_lm import AttentionLM, LMConfig
    from multiverso_tpu_torch.ops import attention
    from multiverso_tpu_torch.utils.configure import set_flag

    counts = attention.LAUNCHES
    out = {"runs": []}
    n_tok = LM_BATCH * LM["seq"]

    def run(what, fn, want_launches):
        counts["flash_block_attn"] = 0
        val, dt = timed(fn)
        n = counts["flash_block_attn"]
        assert n == want_launches, (what, n, want_launches)
        out["runs"].append({"run": what, "seconds": dt, "launches": n})
        return val, dt

    cfg = LMConfig(**LM, seed=0)
    (lm, init_s) = timed(lambda: AttentionLM(cfg, dev))
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"attention LM {LM}, batch {LM_BATCH}: {n_params} parameters, "
        f"built on the card in {init_s:.2f} s")
    # batches[0] is held out, batches[1] warms fit up, the rest are timed.
    batches = cyclic_batches(LM_STEPS + 2, LM_BATCH, LM["seq"], LM_CYCLE)
    tokens = batches[0]
    set_flag("flash_attention", False)
    run("warm-up loss", lambda: lm.loss(tokens), 0)
    losses = {}
    for mode in ("ring", "ulysses"):
        cfg.sp_mode = mode
        for flash in (False, True):
            set_flag("flash_attention", flash)
            want = LM["layers"] if flash else 0
            run(f"loss {mode} flash={flash}", lambda: lm.loss(tokens), want)
            loss, dt = run(f"loss {mode} flash={flash} (timed)",
                           lambda: lm.loss(tokens), want)
            losses[(mode, flash)] = loss
            out[f"loss_{mode}_flash_{str(flash).lower()}"] = loss
            out[f"loss_tokens_per_sec_{mode}_flash_{str(flash).lower()}"] = \
                n_tok / dt
            log(f"LM loss() {mode}, flash {flash}: {loss}, "
                f"{n_tok / dt:.6g} tokens/sec ({dt * 1e3:.2f} ms; B6 "
                f"launches {want}) [{card}]")
            assert math.isfinite(loss), (mode, flash, loss)
        on, off = losses[(mode, True)], losses[(mode, False)]
        assert abs(on - off) <= LM_LOSS_RTOL * abs(off), (mode, on, off)
    cfg.sp_mode = "ring"
    set_flag("flash_attention", False)
    torch.cuda.reset_peak_memory_stats(dev)
    # One untimed step first: it allocates Adam's state and warms the
    # backward pass, which the timed window should not pay.
    (warm_loss,), _ = run("fit warm-up step ring flash=False",
                          lambda: lm.fit(batches[1:2]), 0)
    fit_losses, dt = run(f"fit {LM_STEPS} steps ring flash=False",
                         lambda: lm.fit(batches[2:]), 0)
    assert all(math.isfinite(x) for x in [warm_loss] + fit_losses), \
        (warm_loss, fit_losses)
    out["fit_warm_up_loss"] = warm_loss
    out["fit_losses"] = fit_losses
    out["fit_tokens_per_sec"] = LM_STEPS * n_tok / dt
    out["fit_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    after, _ = run("loss after fit ring flash=False",
                   lambda: lm.loss(tokens), 0)
    out["loss_after_fit"] = after
    # The batches share one cyclic rule, so 4 steps must lower the loss
    # of a batch the model did not train on.
    assert after < losses[("ring", False)], (after, losses)
    log(f"LM fit, {LM_STEPS} steps (ring, flash off, Adam): losses "
        f"{fit_losses}, {out['fit_tokens_per_sec']:.6g} tokens/sec "
        f"({dt:.3f} s, after one untimed step: loss {warm_loss}), peak "
        f"{out['fit_peak_gib']:.2f} GiB; loss() of the held-out batch "
        f"{losses[('ring', False)]} before, {after} after [{card}]")
    del lm
    torch.cuda.empty_cache()

    mcfg = LMConfig(**dict(LM, layers=MOE_LAYERS), moe_experts=MOE_EXPERTS,
                    seed=0)
    moe = AttentionLM(mcfg, dev)
    (moe_loss,), dt = run("MoE fit 1 step ring flash=False",
                          lambda: moe.fit(batches[1:2]), 0)
    out["moe_fit_tokens_per_sec"] = n_tok / dt
    off, _ = run("MoE loss ring flash=False", lambda: moe.loss(tokens), 0)
    set_flag("flash_attention", True)
    on, dt = run("MoE loss ring flash=True", lambda: moe.loss(tokens),
                 MOE_LAYERS)
    set_flag("flash_attention", False)
    assert all(math.isfinite(x) for x in (moe_loss, off, on))
    assert abs(on - off) <= LM_LOSS_RTOL * abs(off), (on, off)
    out.update(moe_fit_loss=moe_loss, moe_loss_flash_false=off,
               moe_loss_flash_true=on,
               moe_loss_tokens_per_sec_flash_true=n_tok / dt)
    log(f"MoE LM ({MOE_EXPERTS} experts, {MOE_LAYERS} layers): first fit step "
        f"loss {moe_loss} ({out['moe_fit_tokens_per_sec']:.6g} tokens/sec),"
        f" loss() flash off {off}, on {on} ({n_tok / dt:.6g} tokens/sec; "
        f"B6 launches {MOE_LAYERS}) [{card}]")
    del moe
    torch.cuda.empty_cache()
    out["b6_launches"] = sum(r["launches"] for r in out["runs"])
    return out


# ---------------------------------------------------------------------------
# phase 7: the attention LM served on the card
# ---------------------------------------------------------------------------
class HistWindow:
    """What one of the registry's latency histograms observed from now
    until ``read``: the bucket counts' difference, read through the
    histogram's public ``raw_counts``, as the telemetry's windowed
    percentiles are (log-2 buckets, geometric interpolation inside one)."""

    def __init__(self, name: str):
        from multiverso_tpu_torch.telemetry import histogram
        self.hist = histogram(name)
        self.count, self.counts = self.hist.raw_counts()

    def read(self):
        n, counts = self.hist.raw_counts()
        return n - self.count, [c - c0 for c, c0 in zip(counts,
                                                        self.counts)]

    def pct(self, q: float) -> float:
        from multiverso_tpu_torch.telemetry import Histogram
        n, counts = self.read()
        return Histogram.percentile_from_counts(counts, n, q / 100) \
            if n else float("nan")


def pct(values, q):
    import numpy as np
    return float(np.percentile(np.asarray(values), q)) if values else \
        float("nan")


def drive(cli, runner_id, prompts, in_flight):
    """Send every prompt over ``cli`` with ``in_flight`` requests
    outstanding; returns (tokens per prompt, request latencies in ms,
    wall seconds, errors)."""
    import queue
    import threading
    import numpy as np

    todo = queue.Queue()
    for i in range(len(prompts)):
        todo.put(i)
    tokens = [None] * len(prompts)
    lat = [0.0] * len(prompts)
    errors = []

    def worker():
        while True:
            try:
                i = todo.get_nowait()
            except queue.Empty:
                return
            t0 = time.perf_counter()
            try:
                got = cli.generate(np.asarray(prompts[i], np.int32),
                                   deadline_ms=600_000, runner_id=runner_id,
                                   timeout=600)
                tokens[i] = got.tolist()
            except Exception as e:  # noqa: BLE001 - counted, then failed
                errors.append((i, repr(e)))
            lat[i] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=worker) for _ in range(in_flight)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        assert not t.is_alive(), "a serving client thread hung"
    return tokens, lat, time.perf_counter() - t0, errors


def teacher_forced(params, cfg, prompts, served, dev):
    """Each served token against the port's full ``forward`` on the card
    over prompt + served tokens (teacher forcing): it passes if it is the
    argmax there, or if its logit is within ``TIE_ATOL`` of the largest
    (a tie no float32 summing order can decide). Returns the per-request
    logits rows the check read ([max_new, vocab] each, on the card) and
    the count of ties."""
    import torch
    from multiverso_tpu_torch.models.attention_lm import forward

    rows, ties = [], 0
    with torch.no_grad():
        for c in range(0, len(prompts), 8):
            seqs = [p + s[:-1] for p, s in zip(prompts[c:c + 8],
                                                served[c:c + 8])]
            width = max(len(x) for x in seqs)
            toks = torch.zeros((len(seqs), width), dtype=torch.long,
                               device=dev)
            for j, x in enumerate(seqs):
                toks[j, :len(x)] = torch.as_tensor(x, device=dev)
            logits, _ = forward(params, toks, cfg)
            for j, (p, s) in enumerate(zip(prompts[c:c + 8],
                                           served[c:c + 8])):
                lg = logits[j, len(p) - 1:len(p) - 1 + len(s)]
                s_t = torch.as_tensor(s, device=dev)
                mx = lg.max(dim=-1).values
                chosen = lg.gather(1, s_t[:, None])[:, 0]
                arg = lg.argmax(dim=-1) == s_t
                tie = ~arg & (chosen >= mx - TIE_ATOL)
                bad = ~arg & ~tie
                assert not bool(bad.any()), (
                    c + j, int(bad.nonzero()[0, 0]),
                    float((mx - chosen).max()))
                ties += int(tie.sum())
                rows.append(lg.clone())
            del logits
    return rows, ties


def agree(base, other, rows_other):
    """Tokens of another mode against ``base`` under the tie rule: equal
    up to the first difference; there, in the other mode's own
    teacher-forced logits (the same prefix), both tokens within
    ``TIE_ATOL`` of the largest logit. Returns the count of requests that
    diverged at such a tie."""
    diverged = 0
    for i, (a, b) in enumerate(zip(base, other)):
        if a == b:
            continue
        d = next(k for k in range(len(a)) if a[k] != b[k])
        lg = rows_other[i][d]
        top = float(lg.max())
        assert float(lg[a[d]]) >= top - TIE_ATOL and \
            float(lg[b[d]]) >= top - TIE_ATOL, (i, d, a[d], b[d])
        diverged += 1
    return diverged


def teacher_forced_int8(params, cfg, prompts, served, dev):
    """The logits of int8-KV decoding under teacher forcing: each request's
    prompt + served tokens through the model on the card, where the
    prompt's rows attend over exact K and V (the prefill) and every
    generated row over K and V round-tripped through the int8 codec
    (``encode_rows`` then ``decode_rows``, a scale per head row): what the
    paged int8 decode reads. Returns the per-request logits rows of the
    served tokens ([max_new, vocab] each) and the count of served tokens
    that are neither the argmax nor within ``TIE_ATOL`` of the largest
    logit there (not gated: the codec's rounding edges turn float32
    summing-order differences into whole quantization steps)."""
    import torch
    from multiverso_tpu_torch.models.attention_lm import _ln, _posenc
    from multiverso_tpu_torch.serving.quant import decode_rows, encode_rows
    from multiverso_tpu_torch.serving.runners import attn_scale

    H, D = cfg.heads, cfg.dim
    dh = D // H
    scale = attn_scale(dh)
    rows, off = [], 0
    with torch.no_grad():
        for p, s in zip(prompts, served):
            toks = torch.as_tensor(p + s[:-1], device=dev)
            S, n = toks.shape[0], len(p)
            x = params["embed"][toks] + _posenc(S, D, dev)
            causal = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
            for i in range(cfg.layers):
                h = _ln(x)
                q, k, v = (t.reshape(S, H, dh).transpose(0, 1) for t in
                           torch.split(h @ params[f"qkv_{i}"], D, dim=-1))
                kq = decode_rows(*encode_rows(k, "int8"), "int8")
                vq = decode_rows(*encode_rows(v, "int8"), "int8")
                o = torch.empty_like(q)
                for rows_, kk, vv in ((slice(0, n), k, v),
                                      (slice(n, S), kq, vq)):
                    sc = (q[:, rows_] @ kk.transpose(1, 2)) * scale
                    sc = sc.masked_fill(~causal[rows_], float("-inf"))
                    o[:, rows_] = torch.softmax(sc, dim=-1) @ vv
                x = x + o.transpose(0, 1).reshape(S, D) \
                    @ params[f"attn_out_{i}"]
                x = x + torch.nn.functional.gelu(
                    _ln(x) @ params[f"mlp_in_{i}"], approximate="tanh") \
                    @ params[f"mlp_out_{i}"]
            lg = (_ln(x) @ params["out"])[n - 1:n - 1 + len(s)]
            s_t = torch.as_tensor(s, device=dev)
            mx = lg.max(dim=-1).values
            chosen = lg.gather(1, s_t[:, None])[:, 0]
            off += int(((lg.argmax(dim=-1) != s_t)
                        & (chosen < mx - TIE_ATOL)).sum())
            rows.append(lg)
    return rows, off


def serve_lm(dev, card) -> dict:
    """The attention LM served on the card through ``ServingService`` and
    ``ServingClient`` (see the module's docstring). Each mode's run sets
    every launch count to 0 just before it and reads them just after.
    Modes: continuous paged, drain preallocated, drain paged (float32
    pages); continuous paged and drain paged with int8 pages (B7's int8
    instance); and, on a variant of the workload whose repeated prompt
    reaches into the straddle page of 24-position pages at bucket 128,
    continuous paged without and with the prefix cache."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.models.attention_lm import (LMConfig,
                                                          init_params)
    from multiverso_tpu_torch.ops import attention, rows, sgns
    from multiverso_tpu_torch.serving import (AttentionLMRunner,
                                              ServingClient, ServingService,
                                              page_plan)
    from multiverso_tpu_torch.serving.pipeline import \
        measured_dispatch_latency_ms
    from multiverso_tpu_torch.telemetry import get_registry

    cfg = LMConfig(**LM, seed=0)
    params, init_s = timed(lambda: {
        k: v.cpu().numpy() for k, v in init_params(cfg).items()})
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 60, SERVE_BUCKETS[-1] // 3).tolist()
    prompts = decode_workload(rng, SERVE_REQUESTS, SERVE_BUCKETS[-1], 0.5,
                              shared)
    # The prefix variant: the same draw with a repeated prompt of 124
    # tokens (bucket 128), whose tail lies in the straddle page of
    # 24-position pages: a sharer copies that page on extend.
    shared_p = np.random.default_rng(17).integers(1, 60, 124).tolist()
    prefix_prompts = decode_workload(np.random.default_rng(7),
                                     SERVE_REQUESTS, SERVE_BUCKETS[-1], 0.5,
                                     shared_p)
    plan = page_plan(len(shared_p), SERVE_BUCKETS[0], SERVE_MAX_NEW,
                     SERVE_PREFIX_PAGE)
    assert plan.straddle_has_prompt, plan
    n_tail = sum(len(p) > SERVE_BUCKETS[0] for p in prompts)
    log(f"serving: GPT-2-small widths {LM}, weights from seed 0 "
        f"({init_s:.2f} s), max_new {SERVE_MAX_NEW}, max_batch "
        f"{SERVE_BATCH}, buckets {SERVE_BUCKETS}, page {SERVE_PAGE}; "
        f"{len(prompts)} prompts (serve_bench's _decode_workload, seed 7): "
        f"{sum(p == shared for p in prompts)} repeats of one "
        f"{len(shared)}-token prompt, {n_tail} over {SERVE_BUCKETS[0]} "
        f"tokens, lengths {min(map(len, prompts))}..{max(map(len, prompts))}"
        f"; the prefix variant: {sum(p == shared_p for p in prefix_prompts)}"
        f" repeats of one {len(shared_p)}-token prompt, pages of "
        f"{SERVE_PREFIX_PAGE}")
    paged = dict(paged=True, page=SERVE_PAGE)
    cont = dict(continuous=True, paged=True, kv_page=SERVE_PAGE)
    pre_page = dict(paged=True, page=SERVE_PREFIX_PAGE)
    pre_cont = dict(continuous=True, paged=True, kv_page=SERVE_PREFIX_PAGE)
    # (name, runner kwargs, register_runner kwargs, workload, B7 counter)
    modes = (("continuous paged", paged, cont, "main", "paged_decode_attn"),
             ("drain preallocated", {}, dict(pipeline_depth="auto"), "main",
              None),
             ("drain paged", paged, dict(pipeline_depth="auto"), "main",
              "paged_decode_attn"),
             ("continuous paged int8", dict(paged, kv_dtype="int8"),
              dict(cont, kv_dtype="int8"), "main",
              "paged_decode_attn_int8"),
             ("drain paged int8", dict(paged, kv_dtype="int8"),
              dict(pipeline_depth="auto"), "main",
              "paged_decode_attn_int8"),
             ("continuous paged, prefix workload", pre_page, pre_cont,
              "prefix", "paged_decode_attn"),
             ("continuous paged, prefix cache", pre_page,
              dict(pre_cont, prefix_entries=SERVE_PREFIX_ENTRIES), "prefix",
              "paged_decode_attn"))
    workloads = {"main": prompts, "prefix": prefix_prompts}
    svc = ServingService()
    cli = None
    out = {"modes": {}}
    try:
        runners = []
        for rid, (name, rkw, skw, _, _) in enumerate(modes):
            runner = AttentionLMRunner(params, cfg, max_new=SERVE_MAX_NEW,
                                       max_batch=SERVE_BATCH, **rkw)
            svc.register_runner(runner, runner_id=rid,
                                buckets=SERVE_BUCKETS,
                                max_batch=SERVE_BATCH, **skw)
            runners.append(runner)
        warmed, warm_s = timed(svc.warmup)
        probe = measured_dispatch_latency_ms(dev)
        depth = svc.batcher(1).pipeline_depth
        log(f"serving: {warmed} warm-up runs in {warm_s:.2f} s; the "
            f"pipeline probe read {probe:.4f} ms per launch + sync, "
            f"\"auto\" chose depth {depth} [{card}]")
        cli = ServingClient(*svc.address)
        lm_params = runners[0].params_ref()
        served, int8_rows = {}, {}
        reg = get_registry()

        def count(name):
            return reg.counter(name).snapshot()["value"]

        for rid, (name, _, _, load, b7) in enumerate(modes):
            b = svc.batcher(rid)
            mode_prompts = workloads[load]
            h_first = HistWindow("serve.latency.first_token")
            h_per_token = HistWindow("serve.latency.per_token")
            c0 = {k: count(k) for k in (
                "serve.continuous.steps", "serve.batches",
                "serve.prefix.hits", "serve.prefix.prefill_skipped",
                "serve.prefix.copy_on_extend", "serve.continuous.joins")}
            for counts in (rows.LAUNCHES, sgns.LAUNCHES, attention.LAUNCHES):
                for key in counts:
                    counts[key] = 0
            tokens, lat, wall, errors = drive(cli, rid, mode_prompts,
                                              SERVE_IN_FLIGHT)
            launches = dict(attention.LAUNCHES)
            delta = {k: count(k) - v for k, v in c0.items()}
            steps, batches = (delta["serve.continuous.steps"],
                              delta["serve.batches"])
            assert not errors, (name, errors[:3])
            assert all(t is not None and len(t) == SERVE_MAX_NEW
                       for t in tokens), name
            n_tok = SERVE_MAX_NEW * len(mode_prompts)
            rec = {"tokens_per_sec": n_tok / wall, "seconds": wall,
                   "requests": len(mode_prompts), "errors": len(errors),
                   "latency_ms_p50": pct(lat, 50),
                   "latency_ms_p99": pct(lat, 99),
                   "first_token_ms_p50": h_first.pct(50),
                   "first_token_ms_p99": h_first.pct(99),
                   "per_token_ms_p50": h_per_token.pct(50),
                   "per_token_ms_p99": h_per_token.pct(99),
                   "b7_launches": launches["paged_decode_attn"],
                   "b7_int8_launches": launches["paged_decode_attn_int8"],
                   "b6_launches": launches["flash_block_attn"]}
            assert h_first.read()[0] == len(mode_prompts), name
            assert rec["b6_launches"] == 0, rec
            if name.startswith("continuous"):
                rec["engine_steps"] = steps
                rec["pool_high_water_pages"] = b.pool.max_used
                rec["pool_pages"] = b.pool.capacity
                want = LM["layers"] * steps
            elif name.startswith("drain paged"):
                rec["batches"] = batches
                rec["pool_high_water_pages"] = runners[rid].pool_high_water()
                rec["pipeline_depth"] = b.pipeline_depth
                want = LM["layers"] * (SERVE_MAX_NEW - 1) * batches
            else:
                rec["batches"] = batches
                rec["pipeline_depth"] = b.pipeline_depth
                want = 0
            other = ("paged_decode_attn_int8" if b7 == "paged_decode_attn"
                     else "paged_decode_attn")
            assert (launches[b7] if b7 else 0) == want, (name, rec, want)
            assert b7 is None or launches[other] == 0, (name, launches)
            assert want > 0 or name == "drain preallocated"
            served[name] = tokens
            if "int8" in name:
                # The int8 modes' logits are not the float32 forward's:
                # their check reads the int8 teacher-forced logits.
                int8_rows[name], off = teacher_forced_int8(
                    lm_params, cfg, mode_prompts, tokens, dev)
                rec["off_int8_teacher_forced"] = off
                base = served["continuous paged"]
                same = sum(a == c for x, y in zip(base, tokens)
                           for a, c in zip(x, y))
                rec["share_equal_to_f32_continuous"] = same / n_tok
                if name == "drain paged int8":
                    rec["diverged_at_a_tie"] = agree(
                        served["continuous paged int8"], tokens,
                        int8_rows[name])
            else:
                lg_rows, ties = teacher_forced(lm_params, cfg, mode_prompts,
                                               tokens, dev)
                rec["ties"] = ties
                base = {"main": "continuous paged",
                        "prefix": "continuous paged, prefix workload"}[load]
                if name != base:
                    rec["diverged_at_a_tie"] = agree(served[base], tokens,
                                                     lg_rows)
                del lg_rows
            if name == "continuous paged, prefix cache":
                rec["prefix_hits"] = delta["serve.prefix.hits"]
                rec["prefill_skipped"] = delta["serve.prefix.prefill_skipped"]
                rec["copied_on_extend"] = \
                    delta["serve.prefix.copy_on_extend"]
                rec["joins"] = delta["serve.continuous.joins"]
                assert rec["prefix_hits"] > 0, rec
                assert rec["prefill_skipped"] > 0, rec
                assert rec["copied_on_extend"] > 0, rec
                held = sum(len(e.pages())
                           for e in b.prefix._entries.values())
                rec["store_entries"] = len(b.prefix)
                rec["store_pages"] = held
                assert b.pool.free_pages() == b.pool.capacity - held, (
                    b.pool.free_pages(), b.pool.capacity, held)
            out["modes"][name] = rec
            extra = ""
            if "ties" in rec:
                extra += (f"full-forward check: every token passes, "
                          f"{rec['ties']} ties")
            if "off_int8_teacher_forced" in rec:
                extra += (f"{rec['off_int8_teacher_forced']} tokens off the "
                          "int8 teacher-forced argmax beyond TIE_ATOL (not "
                          "gated), share of tokens equal to continuous "
                          f"paged f32 {rec['share_equal_to_f32_continuous']}")
            if "diverged_at_a_tie" in rec:
                extra += (f", {rec['diverged_at_a_tie']} requests diverge "
                          "at a tie")
            if "prefix_hits" in rec:
                extra += (f"; prefix hits {rec['prefix_hits']}, prefills "
                          f"skipped {rec['prefill_skipped']}, straddle pages "
                          f"copied on extend {rec['copied_on_extend']}, "
                          f"{rec['store_entries']} entries hold "
                          f"{rec['store_pages']} pages, every other page "
                          "back in the pool")
            log(f"serving {name}: {len(mode_prompts)} requests, {n_tok} "
                f"tokens in {wall:.3f} s -> {rec['tokens_per_sec']:.6g} "
                f"tokens/sec; first token p50 "
                f"{rec['first_token_ms_p50']:.3f} ms p99 "
                f"{rec['first_token_ms_p99']:.3f} ms; per token p50 "
                f"{rec['per_token_ms_p50']:.4f} ms p99 "
                f"{rec['per_token_ms_p99']:.4f} ms; request p50 "
                f"{rec['latency_ms_p50']:.3f} ms p99 "
                f"{rec['latency_ms_p99']:.3f} ms; B7 launches "
                f"{rec['b7_launches']}, B7 int8 launches "
                f"{rec['b7_int8_launches']}; "
                + (f"engine steps {steps}, " if "engine_steps" in rec
                   else f"batches {batches}, pipeline depth "
                   f"{rec['pipeline_depth']}, ")
                + (f"pool high-water {rec['pool_high_water_pages']} pages, "
                   if "pool_high_water_pages" in rec else "")
                + extra + f" [{card}]")
        out["pipeline_probe_ms"] = probe
        out["pipeline_depth_auto"] = depth
    finally:
        if cli is not None:
            cli.close()
        svc.close()
    torch.cuda.empty_cache()
    out["b7_launches"] = sum(m["b7_launches"] for m in out["modes"].values())
    out["b7_int8_launches"] = sum(m["b7_int8_launches"]
                                  for m in out["modes"].values())
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.ops import _build, attention, rows, sgns

    # Phase 1: build, record the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {list(_build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for kernel, line in ptxas_lines(_build.build_log(name)):
            log(f"  {name}: {kernel}: {line}")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    # Phase 2: kernels against their plain versions.
    mv.init([])
    kernels = check_row_kernels(dev)
    kernels += check_stateful_kernels(dev)
    kernels.append(check_tiled_kernel(dev))
    kernels.append(check_sgns_kernel(dev))
    kernels.append(check_sgns_kernel_bf16(dev))
    kernels.append(check_attention_kernel(dev))
    kernels.append(check_paged_kernel(dev))
    kernels.append(check_paged_kernel_int8(dev))
    variants = check_variants(dev)
    for rec in check_sgns_layouts(dev):
        variants["sgns_block_bf16" if rec["bf16"] else "sgns_block"].append(
            rec)
    layouts = check_scatter_layouts(dev)
    for k in kernels:
        k.setdefault("variants", variants.get(k["name"], []))
        k["variants"] += layouts.get(k["name"], [])
    mv.shutdown()

    # Each main path runs with every launch count set to 0 just before it
    # and read just after it.
    def on_path(fn, *args):
        for counts in (rows.LAUNCHES, sgns.LAUNCHES, attention.LAUNCHES):
            for key in counts:
                counts[key] = 0
        out = fn(*args)
        return out, {**rows.LAUNCHES, **sgns.LAUNCHES, **attention.LAUNCHES}

    # Phase 3: the table plane: stateless (B1, B2), then each stateful
    # updater (the fused route and B1: one stable sort and one kernel an
    # Add, no fold and no B3 on combined lanes), tables without the row
    # kernels (B4's lane-order adds, the fold), then bench.py's row
    # scatter leg (B4).
    mv.init([])
    _, plane = on_path(table_plane)
    assert plane["gather_rows"] > 0, plane
    assert plane["scatter_add_sorted_rows"] > 0, plane
    stateful = {}
    for name in STATEFUL:
        stateful[name], counts = on_path(stateful_table_plane, name)
        stateful[name]["launches"] = {
            k: counts[k] for k in ("fused_stateful_sorted_rows",
                                   "fused_stateful_rows", "fold_sorted_runs",
                                   "gather_rows")}
        # 3 checked Adds + the untimed and 10 timed ones.
        assert counts["fused_stateful_sorted_rows"] == 14, (name, counts)
        assert counts["fold_sorted_runs"] == 0, (name, counts)
        assert counts["fused_stateful_rows"] == 0, (name, counts)
    store_kernels = stateful_add_kernels()
    plain_runs, plain_counts = on_path(plain_tables)
    bf16_plane = bf16_table_plane()
    bf16_stateful, _ = on_path(bf16_stateful_tables)
    negative, _ = on_path(negative_id_tables)
    mv.shutdown()
    leg_ms, leg = on_path(tiled_leg, dev)
    assert leg["tiled_scatter_add_sorted_rows"] == 21, leg

    # Phase 4: the flagship (counts read for B5), float32 and bfloat16;
    # float32 uncompacted; the other variants and the host batch path.
    d, sents = zipf_corpus(V, 512 * 4, 500)
    mv.init([])
    f32, flag = on_path(flagship, sents, d)
    bf16, flag_bf16 = on_path(flagship, sents, d, "bfloat16")
    on_path(flagship, sents, d, "float32", False)
    log(f"flagship bf16 / float32 in this run: words/sec "
        f"{bf16['words_per_sec'] / f32['words_per_sec']:.4f}x, pairs/sec "
        f"{(bf16['pairs'] / bf16['seconds']) / (f32['pairs'] / f32['seconds']):.4f}x")
    other, other_counts = on_path(other_paths, sents, d)
    # The plain block steps add duplicate rows by a stable sort and B4.
    assert other_counts["tiled_scatter_add_sorted_rows"] > 0, other_counts
    mv.shutdown()

    # Phase 5: the CLI, skip-gram/NS (B5) and CBOW/HS (the plain block).
    cli_topics()
    cli_topics(("-cbow=true", "-hs=true"), "in_graph")

    # Phase 6: the attention LM (its runs read B6's count one by one).
    small_lm_against_cpu(dev)
    lm = attention_lm(dev, card)

    # Phase 7: the LM served (each mode reads the counts one by one).
    served = serve_lm(dev, card)

    b4_runs = {"bench.py leg": leg["tiled_scatter_add_sorted_rows"],
               "plain tables": plain_counts["tiled_scatter_add_sorted_rows"],
               "word2vec plain steps":
                   other_counts["tiled_scatter_add_sorted_rows"]}
    launches = {
        "gather_rows": plane["gather_rows"],
        "scatter_add_sorted_rows": plane["scatter_add_sorted_rows"],
        "fused_stateful_sorted_rows": sum(
            r["launches"]["fused_stateful_sorted_rows"]
            for r in stateful.values()),
        "fold_sorted_runs": plain_counts["fold_sorted_runs"],
        "tiled_scatter_add_sorted_rows": sum(b4_runs.values()),
        "sgns_block": flag["sgns_block"],
        "sgns_block_bf16": flag_bf16["sgns_block_bf16"],
        "flash_block_attn": lm["b6_launches"],
        "paged_decode_attn": served["b7_launches"],
        "paged_decode_attn_int8": served["b7_int8_launches"]}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        assert k["launches"] > 0, k
        if k["name"] == "fused_stateful_sorted_rows":
            k["store_add_kernels"] = store_kernels
            for v in k["variants"]:
                if v.get("cols") == COLS and "ms" in v:
                    path = stateful[v["updater"]]
                    v["launches"] = path["launches"][
                        "fused_stateful_sorted_rows"]
                    v["updates_per_sec"] = path["updates_per_sec"]
                    v["model_max_abs_err"] = path["model_max_abs_err"]
        if k["name"] == "fold_sorted_runs":
            # bfloat16 stateful tables fold by the lane-order route
            # instead (no launch of this kernel).
            k["bf16_stateful_tables"] = bf16_stateful
            k["launches_by_run"] = {
                name: r["launches"]["fold_sorted_runs"]
                for name, r in plain_runs.items()}
        if k["name"] == "tiled_scatter_add_sorted_rows":
            k["leg_ms_per_call"] = leg_ms
            k["launches_by_run"] = b4_runs
        if k["name"] in ("sgns_block", "sgns_block_bf16"):
            st = f32 if k["name"] == "sgns_block" else bf16
            k["flagship_words_per_sec"] = st["words_per_sec"]
            k["flagship_pairs_per_sec"] = st["pairs"] / st["seconds"]
        if k["name"] == "gather_rows":
            k["negative_id_routes"] = negative
        if k["name"] == "sgns_block_bf16":
            k["bf16_table_updates_per_sec"] = bf16_plane["updates_per_sec"]
            k["other_paths_words_per_sec"] = {
                name: st["words_per_sec"] for name, st in other.items()}
        if k["name"] == "flash_block_attn":
            k["launches_by_run"] = {r["run"]: r["launches"]
                                    for r in lm["runs"]}
        if k["name"] == "paged_decode_attn":
            k["launches_by_mode"] = {name: m["b7_launches"] for name, m
                                     in served["modes"].items()}
            k["serving"] = served
        if k["name"] == "paged_decode_attn_int8":
            k["launches_by_mode"] = {name: m["b7_int8_launches"] for name, m
                                     in served["modes"].items()}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    assert all(key in k for k in kernels for key in keys), kernels
    assert np.isfinite([k["ms"] for k in kernels]).all()
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
