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
   prefix cache (8 entries); then the same widths and weights in 2 heads
   of 384, the first 8 prompts with ``max_new`` 32, continuous paged with
   float32 and then int8 pages (B7's wide instance, exactly 12 launches
   an engine step by the instance its entry point reports, each with the
   splits phase 2 held at the engine's shape; every other mode's
   launches all by the tiled instance). Every request must be answered;
   every float32 mode's served token must be the argmax of the port's
   teacher-forced full ``forward`` on the card or within ``TIE_ATOL`` of
   its largest logit, and so must every token of the wide-head int8
   mode in the int8 teacher-forced logits (below); the drain modes'
   tokens must equal the continuous
   ones up to such a tie, drain int8's continuous int8's (ties judged in
   the int8 teacher-forced logits: generated rows attend over K and V
   round-tripped through the codec), and the prefix cache's those of the
   same prompts without it; the prefix run must hit the store, skip
   prefills and copy a straddle page on extend, and leave every page the
   store does not hold free. Per mode: served tokens/sec, first-token and
   per-token latency p50/p99 (device clock), request latency, the pool's
   high-water pages, the pipeline depth; for int8, the share of tokens
   equal to the float32 continuous run's (not gated);
8. the rest of the table family, its storage, logreg and LDA (the card
   line printed first; ``--seed`` makes the data, default 0): in one
   session with 2 local workers, a 1,000,000 x 50 sgd ``use_pallas``
   sparse matrix table and its ``is_pipeline`` twin (4 slots), each
   taking 10 row Adds of 100,000 ids from worker 1, after each of which
   worker 0's incremental Get must find exactly the touched rows stale
   and leave its cache equal to ``get_rows`` and to the CPU replay (B1,
   B2; the rows crossed and the ms of the incremental Get beside a
   whole-table Get); device KV tables of 1<<20 slots x 50 (default and
   adagrad, host-dict and device directories), 10 Adds of 100,000 Zipf
   int64 keys over the whole int64 range, then Gets of present and
   absent keys, bitwise a CPU replay of the directory (``ops/
   device_hash`` on the CPU: its arrays, slots and the payload's
   ``kv_keys``/``kv_slots``) and of the slab (B4, the fold; insert
   rounds and probe steps per batch); a 1,000,000 x 50 ``use_pallas``
   adagrad table (3 Adds, the fused route) and a bfloat16 table; then
   ``save_all`` of all of them, a restart, ``load_all`` into fresh
   tables, every payload bitwise and the bfloat16 file 2 bytes an
   element (MB and seconds of each); ``CheckpointManager`` retention and
   ``restore_latest``; LDA at V = 1,000,000, K = 1,000 on a Zipf corpus
   of 2^20 tokens over 10,000 documents, blocks of 16,384, 2 sweeps (the
   first block's topics equal to the CPU replay's with the same Gumbel
   noise; counts conserved and non-negative; B4 once a block and once to
   seed; tokens/sec); logreg through ``PSModel`` for one epoch of 20,000
   samples at minibatch 20, softmax at MNIST's widths and FTRL at
   rcv1.binary's (from a libsvm file), each then replayed on the CPU:
   finite losses, a falling loss, weights within ``LR_RTOL`` /
   ``LR_ATOL`` (samples/sec); in the same session, before the npz save,
   phase 9's async checkpoint (c);
9. the lookup serving plane, the async checkpoint and DLRM: (a) in sync
   mode with 2 local workers, bench.py's 1,000,000 x 50 ``use_pallas`` sgd
   table after 10 row Adds of 100,000 ids, served by ``serving_runner``
   with a ``HotRowCache`` of 8,192 rows at staleness 0 behind
   ``ServingService``/``ServingClient`` (serve_bench's lookup shape: 8
   keys a request, buckets 8-64, max batch 8): 2,000 requests of Zipf(1.2)
   keys in 10 bursts with a round of Adds between bursts, every reply
   bitwise the table at its stamped clock (requests/sec, p50/p99, cache
   hits, B1 launches); (b) that table checkpointed and served through
   ``CheckpointReplica`` + ``ReplicaLookupRunner`` at f32 (bitwise the
   checkpoint), bf16 and int8 (within ``roundtrip_bound``, bitwise the CPU
   replay of the decode gather), a hot swap to a newer checkpoint while
   requests run (each reply the bytes of its stamped step, all later
   ones the new bytes), and a ``RoutedLookupClient`` over two half-table
   services by ``row_offset``, bitwise the whole table; (c) phase 8's
   tables saved twice by ``CheckpointManager(backend="orbax")`` with 3
   in-place row Adds (the fused route, B2) issued right after each
   ``maybe_save`` returns, the restored tables bitwise the snapshot
   before them (staged and whole-write seconds beside the npz save's);
   (d) DLRM at the Criteo Kaggle widths (``DLRM_WIDTHS``): a PS model and
   its local twin bitwise after 20 steps, the fold kernel bitwise its
   plain version on every push of those steps, within ``DLRM_RTOL`` of a
   CPU replay (of how far the replay moved each tensor), which a card
   twin with TF32 switched on must exceed; then the online loop, 240
   steps of 128 with a publish every 40, freshness lanes 1 and 4,
   ``ServeLoad`` on field 0's live table, an f32 and an int8 replica
   scoring held-out batches (examples/sec, publishes, AUC per lane,
   achieved/offered requests/sec, p50/p99, the loop's time split between
   steps and publishes), and ``ServeLoad``'s runner bitwise the plain
   gather once training stops;
10. the parameter server across processes: (a) two ``ps_shard_main``
    seats on the card (separate processes, ``-wal`` with sync acks) hold
    bench.py's 1,000,000 x 50 row plane split by
    ``reference_server_offsets``, a ``use_pallas`` sgd table (B2) and a
    default table without the row kernels (B4); the C client
    (``mv_client.cpp`` through ``runtime/ffi.py::CClient``, a worker that
    owns no shard) pushes 10 Adds of 100,000 ids with duplicates into
    each, Gets the same ids back (B1) and reads every shard whole: all
    bitwise the same Adds replayed through the port's store on the CPU
    (rows/sec over the wire; each seat prints its B1/B2/B4 counts on
    exit); the seats are a ``PSShardFleet`` without a client seat: each
    binds an ephemeral port and announces it in its addr file, and the
    client connects to the announced addresses; (b) seat 1 killed with
    SIGKILL and respawned: it binds a fresh port, restores nothing,
    replays its WAL (records and seconds printed) and its shards read
    back bitwise the bytes before the kill; (c)
    ``word2vec_main -world_size=2`` at bench.py's word2vec config on a
    synthetic Zipf corpus of ``W2V_DIST_WORDS`` words, ranks on the card
    by default: exit 0, finite losses, the two ranks' ``embeddings()``
    (pulled after both trained) within ``W2V_RANKS_RTOL``, words/sec per
    rank; then one rank of ``DistributedWord2Vec`` against two in-process
    seats on the card, every table within ``W2V_CARD_RTOL`` of the same
    run on the CPU; (d) ``AsyncTableEngine``: 4 threads staging 5 Adds of
    100,000 ids each into the 1,000,000 x 50 table, drained through B2
    (``use_pallas`` sgd) and B4 (default), every element within its
    recursive-summation bound of a float64 model; the stateful bypass
    (adagrad with the fused route, and without the row kernels: the fold)
    bitwise its CPU replay in the order the threads applied it; (e) the
    C client of (a), and the ASGD convnet's 2 workers through
    ``PyTreeParamManager`` on the card (finite losses, accuracy above
    chance);
11. the collective plane (``torch.distributed`` over gloo): (a) one rank
    on the card: the AUTO probe's ps leg (upload, add, read-back) and
    all-reduce leg at ``PROBE_BYTES`` with each decision, then one
    flagship word2vec block (bench.py's config) under the fused,
    ``hybrid`` and ``model_average`` planes from one seed after a
    warm-up block, every table bitwise the fused plane's and B5 launched
    once a plane; (b) two rank
    processes of this script (``--phase11-rank``) on the one card, one
    world started with ``-coordinator``: ``mv.aggregate`` of a numpy
    vector and a card tensor, the all-gather and reduce-scatter of card
    tensors, bitwise the sums of both ranks' inputs; the probe at world 2
    (the same readings and decisions on both ranks); word2vec
    ``model_average`` at the flagship's widths, one block a rank, every
    merged table bitwise the mean of both ranks' pre-merge tables and the
    same on both (words/sec a rank, B5 once a rank); logreg's
    data-parallel allreduce at MNIST's widths, each rank on half of every
    minibatch, within ``DP_LOSS_RTOL`` and ``LR_RTOL``/``LR_ATOL`` of one
    rank on whole minibatches; (c) ``logreg_main -world_size=2`` over two
    PS ranks on the card (exit 0, rank 0's accuracy above
    ``LR_CLI_MIN_ACC``), and two ``DistributedWord2Vec`` ranks over
    ``PSService`` served from each rank's live input shard through
    ``RoutedLookupClient``, every reply bitwise ``get_rows`` (B1 counted
    under the served gathers);
12. the long-context LM across ranks: rank processes of this script
    (``--phase12-rank``) on the one card, one gloo world each, at
    GPT-2-small widths (``LM``; 6 layers in (b) and (c)) with the cyclic
    batches of phase 6: (a)
    two ranks on ``seq:2``: ``loss()`` in ring and Ulysses mode with
    ``-flash_attention`` off and on (B6 launched exactly 2 x 12 times a
    rank a ring forward and 12 times a Ulysses one), each within
    ``LM_LOSS_RTOL`` of one rank's LM from the same seed, 3 ``fit`` steps
    with the flag off against one rank's (losses, and the loss after the
    last step, within ``P12_FIT_RTOL``; parameters within
    ``P12_PARAM_ATOL``), and the MoE LM's ``loss()``
    (``MOE_LAYERS``, ``MOE_EXPERTS``) against one rank's; (b) four ranks
    on ``data:2,seq:2`` and (c) four on ``stage:2,seq:2`` (the 1F1B
    pipeline, 4 microbatches), 3 ``fit`` steps each against one rank's
    flat LM from the same weights (for (c) ``pipeline_params_to_flat`` of
    the pipeline's); every rank's losses and parameters equal, tokens/sec
    and host-staged bytes a rank, each world's seconds;
13. the serving fleet (``multiverso_tpu_torch/fleet``): (a) ``fleet_main
    -fleet_role=local -fleet_replicas=2 -serve_device=default
    -fleet_supervise=true -fleet_synthetic=1000000x50@<seed>``: two
    replica processes, each serving bench.py's row plane from a
    ``ServerStore`` on the card, behind an in-process router; 4 client
    threads send lookups of 8 Zipf keys through ``FleetClient`` for
    ``FLEET_LOAD_S`` seconds, every reply bitwise the seeded table the
    host computes with numpy (requests/sec, per-request p50/p99); (b)
    ``fleet_main -fleet_role=drain`` while lookups run: exit 0, no
    request fails, every member's ``drains_completed`` advances; (c)
    replica-1 SIGKILLed while lookups run: no request fails (the client's
    failover), the supervisor respawns it, it rejoins the ring at a new
    address (seconds from the kill to the rejoin) and lookups stay
    bitwise; (d) a supervised ``PSShardFleet`` of two seats of phase
    10's tables on the card, checkpointing every ``FLEET_PS_CKPT_S``
    seconds: the C client pushes 5 Adds a table, every seat checkpoints,
    5 more, seat 1 is SIGKILLed at once and respawned by the supervisor,
    restores its checkpoint and replays its WAL, and every shard reads
    back bitwise the CPU replay; (e) each replica run reports its store
    on ``cuda`` and B1 launches, each seat run B1, B2 and B4 launches (a
    SIGKILLed run prints none);
14. a JSON line of the kernels, the card line, and the result line.

Phase 2 also holds the instance that B6's entry point reports against
the one its dispatch table names, at heads of ``B6_REPORT_WIDTHS``.

Phase 2 also holds B6 (``flash_block_attn``) against its plain version:
at the LM's eval shape (8, 12, 1,024, 64, causal), at the ring-step shapes
of ``scripts/bench_flash_attn.py:41`` (non-causal, timed with both bounds,
3xTF32 on the tensor cores and float32 on the CUDA cores, and
``scaled_dot_product_attention`` as the yardstick), at the LM's eval
shape with heads of 128 (the narrow instance of two chunks) and 256 (the
wide instance of two chunks a warpgroup), timed the same way, at the
LM's widths with NaN in the K and V rows of the keys no query sees (the
kernel skips their tiles; the plain version gets clean rows), once each
causal with offsets, fully masked, with a bias, in bfloat16 and at D = 8
and 256, and at heads of ``MID_HEADS`` (causal at the ring's offsets, a
bias, bfloat16, NaN in the unseen keys, two launches bitwise equal),
within ``ATTN_TOL``; and B7 (``paged_decode_attn``) at the
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
that does not divide the bucket, an idle slot and t = 0, and at the
layouts its tiles of several pages meet (``check_paged_int8_layouts``:
live pages in two runs with a tile spanning the gap, split boundaries
inside slots over scattered physical pages, scale planes off a 16-byte
boundary, pages of 6 and of 128), each also poisoned, repeated and
replayed from a graph. Then the wide
instances (``check_wide_kernels``): B5 with ``WIDE_NEG`` negatives (its
grouped variant) on the flagship block, held chunk by chunk within
``SGNS_RTOL`` (the whole block's difference recorded), two launches
bitwise equal, timed with its bound; B6 at D = ``WIDE_HEAD`` at the LM's
eval shape (its launch shape, registers, spills, shared memory and CTAs
an SM read from the runtime; two launches bitwise equal; timed with both
bounds and SDPA), at the two-rank ring's blocks with heads of 320 and
small cases (offsets, a bias, bfloat16 at D = 320 and 512, D = 264, D =
576, NaN in the unseen keys); B7's wide instances (dh 257-512) in
float32, bfloat16 and int8 at dh = ``WIDE_PAGED_HEADS`` at the serving
shape and at the first of them at the long-context shape (NaN or 127 in
the wholly masked pages, repeatable, graph-equal, each launch counted
under the instance the kernel's entry point reports, timed with the byte
bound and, float32, SDPA over the gathered cache; registers, shared
memory and CTAs an SM from the runtime), at phase 7's wide-head
engine's step (8 slots of 2 heads of 384 at buckets 128 and 512, float32
and int8, held the same way and counted under its splits), and small
cases (dh = 264, a pool off its 16-byte boundary and
int8 at 264 on the narrow-row instance, dh = 520 on the column-chunked
one, an idle slot, one CTA a slot and head).

Every launch count is set to 0 just before each main-path run of phases
3, 4, 6, 7, 8, 9, 10, 11 and 12 and read just after it (phase 10's seats
and word2vec ranks, the rank processes of phases 11 and 12, and phase
13's replicas and seats are processes of their own and report theirs),
so the comparisons of phase 2 do not count.
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
# (hold_by_chunk). Kernel and plain version both round each step to
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
# The kernels' wide instances (check_wide_kernels): B5 past 16 negatives
# (the grouped variant; the word2vec paper's 5-20 for small corpora, and
# twice that), B6 past a 256-wide head (D = 320: GPT-2 XL's 1600 / 5;
# 512: two column chunks) and B7 at dh = 320, 384 (GPT-2 small's 768 in
# 2 heads, the served wide mode) and 512.
WIDE_NEG = (20, 40)
WIDE_HEAD = (320, 512)
WIDE_PAGED_HEADS = (320, 384, 512)
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
# The wide-head modes: the same LM widths and weights in 2 heads of 384
# (B7's wide instance), the first 8 prompts of the workload, 32 new
# tokens each, continuous paged with float32 and then int8 pages.
WIDE_SERVE_HEADS, WIDE_SERVE_REQUESTS, WIDE_SERVE_MAX_NEW = 2, 8, 32
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
    the live pairs (dots, gradients, AdaGrad updates) at float32 rate,
    for the streams' K negatives a pair.
    Returns ``(ms, "bytes" or "operations", bytes ms, operations ms)``."""
    import torch
    centers, contexts, negs, n_pairs = streams
    K = negs.shape[-1]
    c = centers[:n_live].reshape(-1)[:int(n_pairs)]
    o = contexts[:n_live].reshape(-1)[:int(n_pairs)]
    k = negs[:n_live].reshape(-1, K)[:int(n_pairs)]
    u_in = int(torch.unique(c).numel())
    u_out = int(torch.unique(torch.cat([o, k.reshape(-1)])).numel())
    p = int(n_pairs)
    n_bytes = p * (2 + K) * 4 + 2 * (u_in + u_out) * D * (param_bytes + 4)
    flops_per_pair = (2 * D * (1 + K) + D * (2 * K + 2) + D * (1 + K)
                      + 7 * D * (2 + K))
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


def hold_by_chunk(tables, streams, n_pairs, lr, adagrad, what: str,
                  cpu_spread: bool = False, rtol=None) -> dict:
    """B5 held against its plain version chunk by chunk (its bfloat16
    instance, and the float32 one where a whole block's training is
    rounding-sensitive): for each live chunk of the block, kernel and
    plain version start from the same tables (the plain version's after
    the chunks before), train that chunk alone, and must agree within
    ``rtol`` (default ``SGNS_BF16_RTOL``; each table's max |kernel -
    plain| over its largest |value|) and the chunk's loss within
    ``SGNS_LOSS_RTOL``. A whole
    block cannot be held so: there one rounding edge that the two cross
    differently changes the steps of every later chunk (see
    ``SGNS_BF16_RTOL``). With ``cpu_spread`` the same chunk also runs
    through the plain version on the CPU, and the card's plain version is
    measured against it (the spread the tolerance is set from). Returns
    the worst of each over the chunks, per table."""
    import torch
    from multiverso_tpu_torch.ops import sgns

    rtol = rtol or SGNS_BF16_RTOL
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
            f"{k} {v:.3e} (limit {rtol[k]:.2g})"
            for k, v in worst.items()) + f"; loss {worst_loss:.3e}"
        + ("; the card's plain vs the CPU's: " + ", ".join(
            f"{k} {v:.3e}" for k, v in spread_cpu.items())
           if cpu_spread else ""))
    for name in TABLES:
        assert worst[name] <= rtol[name], (what, name, worst)
    assert worst_loss <= SGNS_LOSS_RTOL, (what, worst_loss)
    out = {"max_rel_err_tables": worst, "max_abs_err_tables": worst_abs,
           "max_loss_rel_err": worst_loss}
    if cpu_spread:
        out["plain_card_vs_cpu"] = spread_cpu
    return out


def check_sgns_kernel_bf16(dev) -> dict:
    """B5's bfloat16 instance on the flagship block with bfloat16
    embeddings (bench.py's ``w2v_words_per_sec_bf16`` leg): held against
    the card's plain version chunk by chunk (``hold_by_chunk``, with
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
    by_chunk = hold_by_chunk(tables, streams, n_pairs, lr, True,
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
            rec.update(hold_by_chunk(tables, streams, n_pairs, 0.025,
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
            return {"layout": what, "bf16": True, **hold_by_chunk(
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


def attn_errors(got, want) -> dict:
    """B6's (o, m, l) against the plain version's: the largest |difference|
    of o / l and its largest ratio to ``ATTN_TOL``'s allowance (<= 1 is
    within), the largest relative l and m differences, and whether all
    are within ``ATTN_TOL``."""
    import torch
    torch.cuda.synchronize()
    (o2, m2, l2), (o1, m1, l1) = got, want
    n2 = o2 / torch.clamp(l2, min=1e-20)
    n1 = o1 / torch.clamp(l1, min=1e-20)
    diff = (n2 - n1).abs()
    rec = {"o_err": float(diff.max()),
           "o_margin": float((diff / (ATTN_TOL["o_atol"] + ATTN_TOL["o_rtol"]
                                      * n1.abs())).max()),
           "l_rel": float(((l2 - l1).abs() / l1.abs()).max()),
           "m_rel": float(((m2 - m1).abs() / m1.abs()).max()),
           "finite": all(bool(torch.isfinite(t).all()) for t in got)}
    rec["within_tol"] = (rec["finite"] and rec["o_margin"] <= 1.0
                         and rec["l_rel"] <= ATTN_TOL["l_rtol"]
                         and rec["m_rel"] <= ATTN_TOL["m_rtol"])
    return rec


def attn_compare(what, got, want) -> float:
    """Hold B6's (o, m, l) against the plain version's within
    ``ATTN_TOL``; returns the largest |difference| of o / l."""
    e = attn_errors(got, want)
    log(f"  {what}: max |o/l - plain| {e['o_err']:.3e} ({e['o_margin']:.3f} "
        f"of its allowance), max rel l {e['l_rel']:.3e}, max rel m "
        f"{e['m_rel']:.3e}")
    assert e["finite"], f"{what}: not finite"
    assert e["o_margin"] <= 1.0, (what, e["o_err"])
    assert e["l_rel"] <= ATTN_TOL["l_rtol"], (what, e["l_rel"])
    assert e["m_rel"] <= ATTN_TOL["m_rtol"], (what, e["m_rel"])
    return e["o_err"]


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
    (non-causal), timed; the instances of heads of 128 and 256 at the
    LM's eval shape, held and timed; on inputs with NaN in the K and V
    rows that no query sees (the LM's widths with twice the keys), against
    the plain version on the clean inputs; at the blocks phase 12's
    two-rank ring gives it (half the LM's sequence, causal, at each block
    offset pair the ring visits, one wholly masked); then once each at a
    small shape: causal with offsets, fully masked, with a bias, bfloat16,
    D = 8 and D = 256; and the heads of ``MID_HEADS`` at small shapes
    (:func:`check_attention_mid_widths`)."""
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
    variants = [{"case": "NaN in the unseen keys' K and V, LM widths",
                 "max_abs_err": poisoned}]
    # Phase 12's ring at seq:2: rank r's queries at offset r * s/2 meet
    # the keys of rank r, then of rank 1 - r.
    half = s // 2
    q, k, v = attn_inputs(g, dev, b, h, half, half, dh)
    for offs in ((0, 0), (half, half), (half, 0), (0, half)):
        e, _, _ = pair(f"B6 two-rank ring block {(b, h, half, dh)}, causal "
                       f"offsets {offs}", q, k, v, scale=dh ** -0.5,
                       causal=True, offsets=offs)
        variants.append({"case": f"two-rank ring block {[b, h, half, dh]}, "
                         f"causal offsets {list(offs)}", "max_abs_err": e})
    del q, k, v
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

    # The instances of heads of 128 (narrow, two chunks) and 256 (wide,
    # two chunks a warpgroup) at the LM's eval shape, held within ATTN_TOL
    # (ROADMAP C9's witness: each 64-column chunk of Q.K^T summed from 0)
    # and timed.
    for d2 in (128, 256):
        q, k, v = attn_inputs(g, dev, b, h, s, s, d2)
        kw = dict(scale=d2 ** -0.5, causal=True, offsets=(0, 0))
        served = attention.B6_INSTANCES[attention.b6_instance(d2)]
        got = attention.flash_block_attn(q, k, v, **kw)
        assert attention.B6_INSTANCES[attention.b6_instance(d2)] == \
            served + 1, d2
        want = attention.flash_block_attn_plain(q, k, v, **kw)
        errs = attn_errors(got, want)
        attn_compare(f"B6 {attention.b6_instance(d2)} at the LM's eval "
                     f"shape {(b, h, s, d2)}, causal", got, want)
        del got, want
        t = time_attn(q, k, v, True, 10)
        bd = attn_bounds(b, h, s, s, d2, causal=True, offsets=(0, 0))
        info = attention.describe(d2)
        log(f"B6 {info['instance']} {(b, h, s, d2)} causal: kernel "
            f"{t['ms']:.4f} ms ({t['graph_ms']:.4f} ms in a CUDA graph), "
            f"plain {t['plain_ms']:.4f} ms, {t['library']} "
            f"{t['library_ms']:.4f} ms, {bounds_text(bd)}; "
            f"{info['registers']} registers, {info['local_bytes']} local "
            f"bytes, {info['smem_bytes']} bytes of shared memory, "
            f"{info['ctas_per_sm']} CTAs an SM")
        shapes.append({"shape": [b, h, s, d2], "causal": True,
                       "max_abs_err": errs["o_err"], "errors": errs,
                       **info, **t, **bd})
        del q, k, v
        torch.cuda.empty_cache()

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
    variants += check_attention_mid_widths(dev, g)
    reported = check_b6_reported_instances(dev, g)
    return {"name": "flash_block_attn", "route": "cuda",
            "source": "multiverso_tpu_torch/csrc/attention.cu",
            "replaces": "multiverso_tpu/ops/pallas_attention.py:97",
            "shape": [b, h, s, dh], "causal": True, "max_abs_err": err,
            **rec, **bound, "shapes": shapes, "variants": variants,
            "reported_instances": reported}


#: The head widths at which phase 2 holds the instance that B6's entry
#: point reports against the one its dispatch table names.
B6_REPORT_WIDTHS = (64, 128, 192, 256, 320, 512)


def check_b6_reported_instances(dev, g) -> dict:
    """One launch of B6 at each of ``B6_REPORT_WIDTHS`` (a small causal
    shape): the launch is counted under the instance that the entry
    point reports it took, which must be the one ``b6_instance`` names,
    and under no other. Returns {width: instance}."""
    from multiverso_tpu_torch.ops import attention

    out = {}
    for d in B6_REPORT_WIDTHS:
        q, k, v = attn_inputs(g, dev, 1, 2, 128, 128, d)
        before = dict(attention.B6_INSTANCES)
        attention.flash_block_attn(q, k, v, scale=d ** -0.5, causal=True)
        moved = {name: n - before[name]
                 for name, n in attention.B6_INSTANCES.items()
                 if n != before[name]}
        assert moved == {attention.b6_instance(d): 1}, (d, moved)
        out[d] = attention.b6_instance(d)
    log("B6 reported instances: " + ", ".join(
        f"D={d} {name}" for d, name in out.items()))
    return out


#: Heads of 65-256 columns held at small shapes: the narrow instance of
#: two chunks (72: a last chunk of 8) and the wide instance of two chunks
#: a warpgroup (136 and 200: a last chunk of 8 on warpgroup 1).
MID_HEADS = (72, 136, 192, 200, 256)


def check_attention_mid_widths(dev, g) -> list:
    """B6 at each of ``MID_HEADS`` on small shapes, within ``ATTN_TOL``,
    each launch counted under the instance that serves the width: causal
    at the ring's offsets (0, 0), (384, 128) and (128, 384), two launches
    bitwise equal, a band bias, bfloat16, and NaN in the K and V rows of
    the keys no query sees (against the plain version on clean rows)."""
    import torch
    from multiverso_tpu_torch.ops import attention

    def pair(what, q, k, v, bias=None, want=None, **kw):
        d = q.shape[-1]
        served = attention.B6_INSTANCES[attention.b6_instance(d)]
        got = attention.flash_block_attn(q, k, v, bias, **kw)
        assert attention.B6_INSTANCES[attention.b6_instance(d)] == \
            served + 1, what
        ref = attention.flash_block_attn_plain(*(want or (q, k, v)), bias,
                                               **kw)
        return attn_compare(what, got, ref), got

    out = []
    for d in MID_HEADS:
        name = attention.b6_instance(d)
        sc = d ** -0.5
        q, k, v = attn_inputs(g, dev, 2, 3, 128, 256, d)
        for offs in ((0, 0), (384, 128), (128, 384)):
            e, got = pair(f"B6 {name} D={d} causal offsets {offs}", q, k, v,
                          scale=sc, causal=True, offsets=offs)
            out.append({"case": f"D={d} causal offsets {list(offs)}",
                        "instance": name, "max_abs_err": e})
            if offs == (0, 0):
                again = attention.flash_block_attn(q, k, v, scale=sc,
                                                   causal=True, offsets=offs)
                assert all(torch.equal(x, y) for x, y in zip(got, again)), d
                log(f"  B6 {name} D={d}: two launches bitwise equal")
        q, k, v = attn_inputs(g, dev, 2, 3, 256, 384, d)
        band = torch.where(torch.arange(384, device=dev)[None, :]
                           > torch.arange(256, device=dev)[:, None] + 100,
                           attention.NEG_INF, 0.0).to(torch.float32)
        out.append({"case": f"D={d} bias", "instance": name,
                    "max_abs_err": pair(f"B6 {name} D={d} bias", q, k, v,
                                        band, scale=sc)[0]})
        out.append({"case": f"D={d} bfloat16", "instance": name,
                    "max_abs_err": pair(
                        f"B6 {name} D={d} bfloat16",
                        *(t.to(torch.bfloat16) for t in (q, k, v)),
                        scale=sc)[0]})
        # Keys 128..383 come after every query at offsets (0, 0).
        kp, vp = (torch.cat([t[:, :, :128], torch.full_like(
            t[:, :, 128:], float("nan"))], dim=2) for t in (k, v))
        qq = q[:, :, :128].contiguous()
        out.append({"case": f"D={d}, NaN in the unseen keys' K and V",
                    "instance": name, "max_abs_err": pair(
                        f"B6 {name} D={d}, keys 128..383 NaN (kernel) or "
                        "clean (plain)", qq, kp, vp, want=(qq, k, v),
                        scale=sc, causal=True, offsets=(0, 0))[0]})
        del q, k, v, kp, vp, qq
    return out


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


def paged_shapes(dev, dtype=None, scales=None, dh=None):
    """B7's two main-path shapes, one at a time: (what, bucket, args).
    The serving phase's shape (8 slots, 12 heads, dh 64, page 16, bucket
    512, max_new 64: G = 36) over one layer of a pool of the serving
    phase's size, a page table from real page plans of the serving
    workload's mixed lengths (one full prompt) and mixed t; then a
    long-context shape: 8 full prompts at bucket 2,048 (G = 132), one
    layer of a pool that holds them. ``dtype`` int8: the pools encoded by
    the serving codec, their scale planes into ``scales``. ``dh`` widens
    the heads (the same draws otherwise)."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.serving import default_pool_pages
    g = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.default_rng(7)
    S, N, P = SERVE_BUCKETS[-1], SERVE_MAX_NEW, SERVE_PAGE
    H, dh = LM["heads"], dh or LM["dim"] // LM["heads"]
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


def wide_serve_shapes(dev, dtype=None, scales=None):
    """B7's inputs in phase 7's wide-head modes, one bucket at a time:
    (what, bucket, args). The continuous engine's decode step:
    ``SERVE_BATCH`` slots of ``WIDE_SERVE_HEADS`` heads of
    ``LM["dim"] // WIDE_SERVE_HEADS`` columns, a page table of the
    engine's width (``pages_of(bucket + WIDE_SERVE_MAX_NEW, page)``) from
    real page plans of the workload's lengths cut to the bucket (one full
    prompt) and mixed t, over one layer of a 12-layer pool of the
    engine's size. ``dtype`` and ``scales`` as in ``paged_shapes``."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.serving import default_pool_pages
    g = torch.Generator(device=dev).manual_seed(19)
    rng = np.random.default_rng(19)
    N, P, H = WIDE_SERVE_MAX_NEW, SERVE_PAGE, WIDE_SERVE_HEADS
    n_phys = default_pool_pages(SERVE_BUCKETS, SERVE_BATCH, N, P) + 1
    for S in SERVE_BUCKETS:
        lengths = [min(len(p), S) for p in decode_workload(
            rng, SERVE_BATCH, S, 0.0, [])]
        lengths[0] = S
        t = rng.integers(0, N, SERVE_BATCH).tolist()
        yield "at the wide-head engine's step", S, paged_inputs(
            g, dev, lengths, t, S, N, P, H, LM["dim"] // H, n_phys,
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


def paged_pair(what, args, kw, want=None, counter="paged_decode_attn",
               instance=None, splits=None):
    """B7 (the wrapper on the card) against its plain version within
    ``PAGED_TOL``: ``args`` and ``kw`` the wrapper's, ``want`` the plain
    version's ``(args, kw)`` where they differ (clean pages for a poisoned
    launch); the launch must count one on ``counter`` and, where named,
    one on ``instance`` of ``B7_INSTANCES`` (the instance the kernel's
    entry point reports) and one on ``splits`` of ``B7_SPLITS``. Returns
    the max abs error."""
    import torch
    from multiverso_tpu_torch.ops import attention
    before = attention.LAUNCHES[counter]
    served = dict(attention.B7_INSTANCES)
    split = dict(attention.B7_SPLITS)
    got = attention.paged_decode_attn(*args, **kw)
    assert attention.LAUNCHES[counter] == before + 1, what
    if instance is not None:
        served[instance] += 1
        assert attention.B7_INSTANCES == served, (what, instance)
    if splits is not None:
        split[splits] = split.get(splits, 0) + 1
        assert attention.B7_SPLITS == split, (what, splits,
                                              attention.B7_SPLITS)
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
        splits = attention.paged_launch_splits(q, kp, G, P, sms)
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
    not divide the bucket, an idle slot on the garbage page, t = 0, one
    small case per template instance, and the layouts of
    :func:`check_paged_int8_layouts`."""
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
        splits = attention.paged_launch_splits(q, kp, G, P, sms)
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
    variants += check_paged_int8_layouts(dev, g, sms)
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


def misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary: B7 then stages its scales 4 bytes a row."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


def scattered_pages(args, n_phys: int, rng):
    """``args`` with the page table's physical pages renumbered by a
    random permutation of 1 .. n_phys - 1 (the garbage page 0 kept), so a
    slot's neighbouring logical pages lie on far-apart physical pages."""
    import numpy as np
    import torch
    ptab = args[3]
    perm = torch.as_tensor(np.concatenate(
        [[0], 1 + rng.permutation(n_phys - 1)]), dtype=ptab.dtype,
        device=ptab.device)
    return (*args[:3], perm[ptab.long()], *args[4:])


def check_paged_int8_layouts(dev, g, sms: int) -> list:
    """B7's int8 instance at the layouts its tiles of several pages meet
    (``paged_tile_pages``: four pages of 16 rows of 64 a tile), each held
    within ``PAGED_TOL``, again with payloads of 127 and NaN scales in
    every page the mask wholly excludes, and launched twice (bitwise
    equal) and from a CUDA graph: a slot whose live pages form two runs
    (the prompt's, then the generated page past the bucket) with a tile
    spanning the gap; the serving widths with split boundaries inside
    slots and the pages scattered over the pool; scale planes that do not
    start on a 16-byte boundary (4-byte copies); pages of 6 (whose scales
    are not whole 16-byte vectors; ten pages a tile) and of 128 (a page
    two tiles)."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.ops import attention

    rng = np.random.default_rng(12)

    def hold(what, args, sc, page, bucket, align=True):
        kw = dict(bucket=bucket, page=page, scale=args[0].shape[2] ** -0.5)
        fix = (lambda d: d) if align else (
            lambda d: {k: misaligned(v) for k, v in d.items()})
        sc = fix(sc)
        err = paged_pair(f"B7 int8 {what}", args, {**kw, **sc},
                         counter="paged_decode_attn_int8")
        poisoned, n_dead, bad = paged_poisoned(args, bucket, page, sc)
        nan_err = paged_pair(
            f"B7 int8 {what}, payload 127 and NaN scales in the {n_dead} "
            "wholly masked pages", poisoned, {**kw, **fix(bad)},
            want=(args, {**kw, **sc}), counter="paged_decode_attn_int8")
        paged_repeatable(f"B7 int8 {what}", args, {**kw, **sc})
        G = args[3].shape[1]
        return {"case": what, "max_abs_err": err,
                "nan_excluded_pages_max_abs_err": nan_err,
                "tile_pages": attention.paged_tile_pages(
                    args[0].shape[2], 1, page),
                "splits": attention.paged_launch_splits(args[0], args[1], G,
                                                        page, sms),
                "bitwise_repeat": True, "graph_equals_eager": True}

    def live_of(args, bucket, page, b):
        G = args[3].shape[1]
        live = attention.paged_live_pages(args[4], args[5], bucket=bucket,
                                          page=page, n_pages=G)
        return torch.nonzero(live[b]).flatten().tolist()

    out = []
    S, N, P = SERVE_BUCKETS[-1], SERVE_MAX_NEW, SERVE_PAGE
    dh = LM["dim"] // LM["heads"]
    sc = {}
    a = paged_inputs(g, dev, [90, 512, 30, 200], [5, 10, 63, 0], S, N, P, 4,
                     dh, 150, dtype=torch.int8, scales=sc)
    tp = attention.paged_tile_pages(dh, 1, P)
    pages = live_of(a, S, P, 0)               # the prompt's 6, then 32
    spans = [pages[i:i + tp] for i in range(0, len(pages), tp)]
    assert any(t[-1] - t[0] >= len(t) for t in spans), spans
    log(f"  B7 int8 two runs: slot 0's live pages {pages}, tiles {spans}")
    out.append(hold("live pages in two runs, a tile spanning the gap", a,
                    sc, P, S))
    out.append(hold("scale planes 4 bytes past a 16-byte boundary", a, sc,
                    P, S, align=False))
    del a
    sc = {}
    lengths = [512, 300, 41, 100, 7, 250, 480, 16]
    a = scattered_pages(paged_inputs(
        g, dev, lengths, rng.integers(0, N, SERVE_BATCH).tolist(), S, N, P,
        LM["heads"], dh, 300, dtype=torch.int8, scales=sc), 300, rng)
    splits = attention.paged_launch_splits(a[0], a[1], a[3].shape[1], P, sms)
    inner = [attention.paged_split_pages(len(live_of(a, S, P, b)), tp,
                                         splits) for b in range(2)]
    assert splits > 1 and all(any(0 < p0 < p1 for p0, p1 in sp)
                              for sp in inner), inner
    log(f"  B7 int8 split boundaries: {splits} CTAs a slot and head, slot "
        f"0's and 1's live pages by split {inner}")
    out.append(hold("serving widths, split boundaries inside slots, pages "
                    "scattered over the pool", a, sc, P, S))
    del a
    for page, bucket, what in ((6, 48, "ten pages a tile"),
                               (128, 256, "a page two tiles")):
        sc = {}
        a = scattered_pages(paged_inputs(
            g, dev, [bucket, bucket // 3, 5, bucket - 1], [0, 9, 15, 3],
            bucket, 16, page, 4, dh, 60, dtype=torch.int8, scales=sc), 60,
            rng)
        out.append(hold(f"page {page} ({what})", a, sc, page, bucket))
        del a
    return out


# ---------------------------------------------------------------------------
# phase 2: the kernels' wide instances (any negative count, any head width)
# ---------------------------------------------------------------------------
def block_negatives(streams, k: int, g):
    """The flagship block's negatives redrawn ``k`` a pair from the
    block's own live negatives (so from the flagship's unigram^0.75
    table), by ``g``: [chunks, CHUNK, k] int32."""
    import torch
    negs5, n_pairs = streams[2], streams[3]
    n_live = (int(n_pairs) + CHUNK - 1) // CHUNK
    pool = negs5[:n_live].reshape(-1)
    return pool[torch.randint(0, pool.numel(), negs5.shape[:2] + (k,),
                              generator=g, device=pool.device)].contiguous()


def check_sgns_negatives(dev) -> list:
    """B5 past 16 negatives (the grouped variant) on the flagship block:
    its centers, contexts and pair count, with ``WIDE_NEG`` negatives a
    pair drawn from the block's own negatives (so from the flagship's
    unigram^0.75 table), float32, AdaGrad. Each is held against the plain
    version chunk by chunk (each chunk from the plain version's tables,
    within ``SGNS_RTOL`` and ``SGNS_LOSS_RTOL``); over the whole block the
    loss is held within ``SGNS_LOSS_RTOL`` and each table's difference is
    recorded, not held: many negatives of a few frequent rows make a
    block's training sensitive to rounding (at K = 40 the plain version
    moves as far between float32 and float64 as the kernel does from
    it; see PERF.md). Two launches bitwise equal; timed by events beside
    the plain version and the bound."""
    import torch
    from multiverso_tpu_torch.ops import sgns

    tables, streams, lr = flagship_block(dev)
    centers, contexts, _, n_pairs = streams
    n_live = (int(n_pairs) + CHUNK - 1) // CHUNK
    g = torch.Generator(device=dev).manual_seed(12)

    def rel(a_t, b_t):
        return {n: float((a.double() - b.double()).abs().max())
                / float(b.abs().max()) for n, a, b in zip(TABLES, a_t, b_t)}

    out = []
    for k in WIDE_NEG:
        negs = block_negatives(streams, k, g)
        st = (centers, contexts, negs)
        what = f"B5 K={k} (grouped variant), flagship block"
        by_chunk = hold_by_chunk(tables, (*st, n_pairs), n_pairs, lr,
                                      True, what, rtol=SGNS_RTOL)
        kern = [t.clone() for t in tables]
        plain = [t.clone() for t in tables]
        lk = float(sgns.sgns_block_cuda(*kern, *st, n_pairs, lr, True))
        lp = float(sgns.sgns_block_plain(*plain, *st, n_pairs, lr, True))
        block = rel(kern, plain)
        log(f"{what}, whole block: loss {lk} vs plain {lp}; kernel vs plain "
            + ", ".join(f"{n} {block[n]:.3e}" for n in TABLES))
        assert abs(lk - lp) <= SGNS_LOSS_RTOL * abs(lp), (what, lk, lp)
        twice = [t.clone() for t in tables]
        assert float(sgns.sgns_block_cuda(*twice, *st, n_pairs, lr,
                                          True)) == lk, what
        for name, a, b in zip(TABLES, twice, kern):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                (what, name)
        del twice, kern
        launch = sgns.prepare_sgns_block(*[t.clone() for t in tables], *st,
                                         n_pairs, lr, True)
        ms = cuda_ms(lambda: sgns.launch_sgns_block(launch), 3, warmup=1)
        plain_ms = cuda_ms(lambda: sgns.sgns_block_plain(
            *plain, *st, n_pairs, lr, True), 1, warmup=0)
        bound = sgns_bound((centers, contexts, negs, n_pairs), n_live)
        log(f"{what}: kernel {ms:.4f} ms per block ({launch.grid} CTAs), "
            f"plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
            f"bytes {bound[2]:.4f}, operations {bound[3]:.4f}); a second "
            "launch bitwise equal")
        out.append({"case": f"K={k}: the grouped variant, flagship block",
                    "k": k, "max_abs_err": max(
                        by_chunk["max_abs_err_tables"].values()),
                    "by_chunk": by_chunk, "block_rel_err": block,
                    "loss": lk,
                    "plain_loss": lp, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound[0], "bound_by": bound[1],
                    "bound_bytes_ms": bound[2], "bound_ops_ms": bound[3],
                    "library_ms": None, "bitwise_repeat": True})
        del launch, plain, negs
        torch.cuda.empty_cache()
    return out


def check_attention_wide(dev) -> list:
    """B6's wide instances (D > 256: two warpgroups a 64-row q tile that
    split the score columns and O's between them, K and V chunks through
    each one's cp.async ring) at the LM's eval shape with heads of
    ``WIDE_HEAD``, causal: the instance's launch shape and resources as
    the runtime reports them, held against the plain version, launched
    twice (bitwise equal), timed by events and in a graph beside the plain
    version, SDPA and both bounds; at the blocks phase 12's two-rank ring
    would give it with heads of 320 (causal at its four offset pairs, one
    wholly masked); then small cases: non-causal with offsets, a bias,
    bfloat16 at D = 320 and 512, D = 264 (a last chunk of 8 columns), D =
    576 (Q streamed, two column spans) and NaN in the unseen keys' K and
    V."""
    import torch
    from multiverso_tpu_torch.ops import attention

    g = torch.Generator(device=dev).manual_seed(13)

    def pair(what, q, k, v, bias=None, want=None, **kw):
        d = q.shape[-1]
        served = attention.B6_INSTANCES[attention.b6_instance(d)]
        got = attention.flash_block_attn(q, k, v, bias, **kw)
        assert attention.B6_INSTANCES[attention.b6_instance(d)] == \
            served + 1, what
        ref = attention.flash_block_attn_plain(*(want or (q, k, v)), bias,
                                               **kw)
        return attn_compare(what, got, ref), got, ref

    out = []
    b, h, s = LM_BATCH, LM["heads"], LM["seq"]
    for d in WIDE_HEAD:
        info = attention.describe(d)
        log(f"B6 {info['instance']} at D={d}: {info['threads']} threads a "
            f"CTA, {info['smem_bytes']} bytes of shared memory, "
            f"{info['registers']} registers and {info['local_bytes']} "
            f"local (spill) bytes a thread, {info['ctas_per_sm']} CTAs an "
            "SM")
        q, k, v = attn_inputs(g, dev, b, h, s, s, d)
        what = f"B6 wide D={d} at the LM's eval shape {(b, h, s, d)}, causal"
        kw = dict(scale=d ** -0.5, causal=True, offsets=(0, 0))
        err, got, _ = pair(what, q, k, v, **kw)
        again = attention.flash_block_attn(q, k, v, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), what
        del got, again
        rec = time_attn(q, k, v, True, 10)
        bound = attn_bounds(b, h, s, s, d, causal=True, offsets=(0, 0))
        log(f"{what}: kernel {rec['ms']:.4f} ms ({rec['graph_ms']:.4f} ms "
            f"in a CUDA graph), plain {rec['plain_ms']:.4f} ms, "
            f"{rec['library']} {rec['library_ms']:.4f} ms, "
            f"{bounds_text(bound)}; two launches bitwise equal")
        out.append({"case": f"D={d}, the wide instance, LM eval shape",
                    "shape": [b, h, s, d], "causal": True,
                    "max_abs_err": err, "bitwise_repeat": True, **info,
                    **rec, **bound})
        del q, k, v
        torch.cuda.empty_cache()
    # Phase 12's ring at seq:2 with heads of 320: rank r's queries at
    # offset r * s/2 meet the keys of rank r, then of rank 1 - r.
    half, d = s // 2, 320
    q, k, v = attn_inputs(g, dev, b, h, half, half, d)
    for offs in ((0, 0), (half, half), (half, 0), (0, half)):
        e, got, want = pair(f"B6 wide two-rank ring block {(b, h, half, d)}, "
                            f"causal offsets {offs}", q, k, v,
                            scale=d ** -0.5, causal=True, offsets=offs)
        if offs == (0, half):  # every key after every query
            assert bool((got[1] == attention.NEG_INF).all()), offs
            assert torch.equal(got[2], want[2]), offs
        out.append({"case": f"two-rank ring block {[b, h, half, d]}, causal "
                    f"offsets {list(offs)}", "max_abs_err": e})
    del q, k, v, got, want
    q, k, v = attn_inputs(g, dev, 2, 3, 128, 256, 320)
    for offs in ((384, 128), (128, 384)):
        e, _, _ = pair(f"B6 wide D=320 causal offsets {offs}", q, k, v,
                       scale=320 ** -0.5, causal=True, offsets=offs)
        out.append({"case": f"D=320 causal offsets {list(offs)}",
                    "max_abs_err": e})
    band = torch.where(torch.arange(256, device=dev)[None, :]
                       > torch.arange(128, device=dev)[:, None] + 50,
                       attention.NEG_INF, 0.0).to(torch.float32)
    out.append({"case": "D=320 bias", "max_abs_err": pair(
        "B6 wide D=320 bias", q, k, v, band, scale=320 ** -0.5)[0]})
    for d in (320, 512):
        q, k, v = attn_inputs(g, dev, 2, 3, 128, 256, d)
        out.append({"case": f"D={d} bfloat16", "max_abs_err": pair(
            f"B6 wide D={d} bfloat16",
            *(t.to(torch.bfloat16) for t in (q, k, v)),
            scale=d ** -0.5)[0]})
    q, k, v = attn_inputs(g, dev, 2, 3, 256, 384, 576)
    out.append({"case": "D=576 (Q streamed, two column spans), causal",
                "max_abs_err": pair("B6 wide D=576 causal", q, k, v,
                                    scale=576 ** -0.5, causal=True,
                                    offsets=(128, 0))[0]})
    q, k, v = attn_inputs(g, dev, 2, 3, 256, 384, 264)
    out.append({"case": "D=264 (a last chunk of 8 columns), causal",
                "max_abs_err": pair("B6 wide D=264 causal", q, k, v,
                                    scale=264 ** -0.5, causal=True,
                                    offsets=(128, 0))[0]})
    kp, vp = (torch.cat([t[:, :, :128], torch.full_like(t[:, :, :256],
                                                        float("nan"))],
                        dim=2) for t in (k, v))
    kc, vc = (torch.cat([t[:, :, :128], t[:, :, :256]], dim=2)
              for t in (k, v))
    qq = q[:, :, :128].contiguous()
    out.append({"case": "D=264, NaN in the unseen keys' K and V",
                "max_abs_err": pair(
                    "B6 wide D=264, keys 128..383 NaN (kernel) or clean "
                    "(plain)", qq, kp, vp, want=(qq, kc, vc),
                    scale=264 ** -0.5, causal=True, offsets=(0, 0))[0]})
    return out


def paged_wide_case(g, dev, lens, t, heads, d, phys, dtype=None,
                    misalign=False):
    """A small B7 case at wide heads (bucket 128, max_new 64, page 16):
    (args, kwargs). ``misalign`` moves the pools one element off their
    16-byte boundary (the narrow-row wide instance)."""
    import torch
    sc = {}
    a = paged_inputs(g, dev, lens, t, 128, 64, 16, heads, d, phys,
                     dtype=dtype, scales=sc)
    if misalign:
        a = list(a)
        for i in (1, 2):
            flat = torch.empty(a[i].numel() + 1, dtype=a[i].dtype,
                               device=dev)
            a[i] = flat[1:].view(a[i].shape).copy_(a[i])
    return a, dict(bucket=128, page=16, scale=d ** -0.5, **sc)


def check_paged_wide(dev) -> dict:
    """B7's wide instances (dh 257-512: one CTA a slot, head and split
    scores each key once over the whole row, tiles of 12 KB of rows in a
    ring in dynamic shared memory) at the serving shape with heads of
    ``WIDE_PAGED_HEADS`` and at the long-context shape with heads of
    ``WIDE_PAGED_HEADS[0]``, float32, bfloat16 and int8 pages: held
    against the plain version within ``PAGED_TOL`` (again with NaN, or
    payloads of 127 and NaN scales, in every page the mask wholly
    excludes), each launch counted under its instance, launched twice
    (bitwise equal) and from a CUDA graph, timed by events and in a graph
    beside the plain version, the byte bound and SDPA over the cache
    gathered beforehand (float32); the instance's registers, shared
    memory and CTAs an SM as the runtime reports them. Then phase 7's
    wide-head modes' own inputs (``wide_serve_shapes``: 8 slots of 2
    heads of 384 at each serving bucket, float32 and int8 pages), held
    the same way, each launch counted under the splits that
    ``paged_launch_splits`` gives there (the records phase 7 holds the
    engine's launches to). Then small cases: dh 264 (float32, bfloat16;
    int8's 264-byte rows take the narrow-row instance), a pool off its
    16-byte boundary (narrow-row), dh = 520 (the column-chunked instance,
    a last chunk of 8), one CTA a slot and head, an idle slot on the
    garbage page. Returns {kernel name: records}."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.ops import attention

    g = torch.Generator(device=dev).manual_seed(14)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    P = SERVE_PAGE
    out = {"paged_decode_attn": [], "paged_decode_attn_int8": []}
    vec = attention.B7_INSTANCE_NAMES[1]
    described = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        name = ("paged_decode_attn_int8" if dtype == torch.int8
                else "paged_decode_attn")
        kind = str(dtype).split(".")[1]
        for dh in WIDE_PAGED_HEADS:
            sc = {}
            for what, S, args in paged_shapes(dev, dtype, sc, dh=dh):
                long = what.endswith("long-context shape")
                if long and dh != WIDE_PAGED_HEADS[0]:
                    sc.clear()
                    continue
                kw = dict(bucket=S, page=P, scale=dh ** -0.5, **sc)
                q, kp, vp, ptab, lens, ts = args
                G = ptab.shape[1]
                label = (f"B7 {kind} wide dh={dh} {what} (B {SERVE_BATCH}, "
                         f"H {q.shape[1]}, page {P}, bucket {S}, G {G})")
                err = paged_pair(label, args, kw, counter=name,
                                 instance=vec)
                if sc:
                    poisoned, n_dead, bad = paged_poisoned(args, S, P, sc)
                    bad_kw = dict(kw, **bad)
                else:
                    poisoned, n_dead = paged_poisoned(args, S, P)
                    bad_kw = kw
                nan_err = paged_pair(
                    f"{label}, the {n_dead} wholly masked pages poisoned",
                    poisoned, bad_kw, want=(args, kw), counter=name,
                    instance=vec)
                del poisoned, bad_kw
                paged_repeatable(label, args, kw)
                kern = lambda: attention.paged_decode_attn(*args, **kw)  # noqa
                rec = {"ms": cuda_ms(kern, 50), "graph_ms": graph_ms(kern),
                       "plain_ms": cuda_ms(
                           lambda: attention.paged_decode_attn_plain(
                               *args, **kw), 20)}
                if dtype == torch.float32:
                    yard = paged_yardstick(args, S, P)
                    rec["sdpa_ms"] = cuda_ms(yard, 50)
                    rec["sdpa_graph_ms"] = graph_ms(yard)
                    del yard
                bound = paged_bound(q, kp, ptab, lens, ts, S, P)
                splits = attention.paged_launch_splits(q, kp, G, P, sms)
                if (dh, dtype) not in described:
                    described[dh, dtype] = attention.paged_describe(
                        dh, dtype)
                res = described[dh, dtype]
                # The ring's occupancy (csrc/paged_attention.cu WideRing).
                assert res["ctas_per_sm"] == (
                    2 if dtype == torch.float32 else 3), res
                sdpa = (f", SDPA over the gathered cache "
                        f"{rec['sdpa_ms']:.4f} ms ({rec['sdpa_graph_ms']:.4f}"
                        " ms in a graph)" if "sdpa_ms" in rec else "")
                log(f"{label}, {splits} CTAs a slot and head: kernel "
                    f"{rec['ms']:.4f} ms ({rec['graph_ms']:.4f} ms in a CUDA "
                    f"graph), plain {rec['plain_ms']:.4f} ms{sdpa}, bound "
                    f"{bound[0]:.4f} ms ({bound[1]}); {res['instance']}: "
                    f"{res['registers']} registers, {res['local_bytes']} "
                    f"local bytes, {res['smem_bytes']} bytes of shared "
                    f"memory, {res['ctas_per_sm']} CTAs an SM")
                out[name].append({
                    "case": f"dh={dh}, {kind} pages, the wide instance, "
                            f"{what}", "shape": [SERVE_BATCH, q.shape[1], dh],
                    "bucket": S, "instance": vec, "max_abs_err": err,
                    "nan_excluded_pages_max_abs_err": nan_err,
                    "splits": splits, **rec, "bound_ms": bound[0],
                    "bound_by": bound[1], "library_ms": None,
                    "resources": res})
                del args, q, kp, vp, kern
                sc.clear()
                torch.cuda.empty_cache()
    # Phase 7's wide-head modes: the engine's step at each bucket.
    wide_dh = LM["dim"] // WIDE_SERVE_HEADS
    for dtype in (torch.float32, torch.int8):
        name = ("paged_decode_attn_int8" if dtype == torch.int8
                else "paged_decode_attn")
        kind = str(dtype).split(".")[1]
        sc = {}
        for what, S, args in wide_serve_shapes(dev, dtype, sc):
            kw = dict(bucket=S, page=P, scale=wide_dh ** -0.5, **sc)
            q, kp, vp, ptab, lens, ts = args
            G = ptab.shape[1]
            splits = attention.paged_launch_splits(q, kp, G, P, sms)
            label = (f"B7 {kind} wide dh={wide_dh} {what} (B {SERVE_BATCH},"
                     f" H {q.shape[1]}, page {P}, bucket {S}, G {G}, "
                     f"{splits} CTAs a slot and head)")
            err = paged_pair(label, args, kw, counter=name, instance=vec,
                             splits=splits)
            if sc:
                poisoned, n_dead, bad = paged_poisoned(args, S, P, sc)
                bad_kw = dict(kw, **bad)
            else:
                poisoned, n_dead = paged_poisoned(args, S, P)
                bad_kw = kw
            nan_err = paged_pair(
                f"{label}, the {n_dead} wholly masked pages poisoned",
                poisoned, bad_kw, want=(args, kw), counter=name,
                instance=vec, splits=splits)
            del poisoned, bad_kw
            paged_repeatable(label, args, kw)
            out[name].append({
                "case": f"dh={wide_dh}, {kind} pages, the wide instance, "
                        f"{what}", "shape": [SERVE_BATCH, q.shape[1],
                                             wide_dh],
                "bucket": S, "pages": G, "kind": kind, "instance": vec,
                "engine_step": True, "max_abs_err": err,
                "nan_excluded_pages_max_abs_err": nan_err,
                "splits": splits})
            del args, q, kp, vp
            sc.clear()
            torch.cuda.empty_cache()
    rng = np.random.default_rng(9)
    slots = -(-attention.PAGED_CTAS_PER_SM * sms // 12)
    lens4, t4 = [3, 60, 128, 17], [0, 5, 63, 20]
    narrow = attention.B7_INSTANCE_NAMES[2]
    chunked = attention.B7_INSTANCE_NAMES[3]
    for dtype in (None, torch.bfloat16, torch.int8):
        name = ("paged_decode_attn_int8" if dtype == torch.int8
                else "paged_decode_attn")
        kind = "float32" if dtype is None else str(dtype).split(".")[1]
        cases = [("dh=264", lens4, t4, 4, 264, 64, False,
                  narrow if dtype == torch.int8 else vec),
                 ("dh=520 (the column-chunked instance, a last chunk of 8)",
                  lens4, t4, 4, 520, 64, False, chunked),
                 ("idle slot on the garbage page, dh=320", [1, 40, 100, 7],
                  [0, 10, 63, 1], 4, 320, 64, False, vec),
                 (f"{slots} slots x 12 heads, dh=320: one CTA a slot and "
                  "head", rng.integers(1, 129, slots).tolist(),
                  rng.integers(0, 64, slots).tolist(), 12, 320,
                  slots * 12 + 1, False, vec),
                 ("dh=320, the pool off its 16-byte boundary", lens4, t4, 4,
                  320, 64, True, narrow)]
        for case, lens_v, t_v, heads, d, phys, off, inst in cases:
            a, kw = paged_wide_case(g, dev, lens_v, t_v, heads, d, phys,
                                    dtype, off)
            if case.startswith("idle"):
                a[3][0] = 0
            if case.startswith(f"{slots} slots"):
                assert attention.paged_launch_splits(
                    a[0], a[1], a[3].shape[1], 16, sms) == 1
            label = f"B7 {kind} wide {case}"
            e = paged_pair(label, a, kw, counter=name, instance=inst)
            if case.startswith("dh=264") or off:
                paged_repeatable(label, a, kw)
            out[name].append({"case": f"{kind} pages, {case}",
                              "instance": inst, "max_abs_err": e})
    return out


def check_wide_kernels(dev) -> dict:
    """The kernels' wide instances: {kernel name: records}."""
    out = {"sgns_block": check_sgns_negatives(dev),
           "flash_block_attn": check_attention_wide(dev)}
    out.update(check_paged_wide(dev))
    return out


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
    dh = LM["dim"] // LM["heads"]

    def run(what, fn, want_launches):
        counts["flash_block_attn"] = 0
        for key in attention.B6_INSTANCES:
            attention.B6_INSTANCES[key] = 0
        val, dt = timed(fn)
        n = counts["flash_block_attn"]
        assert n == want_launches, (what, n, want_launches)
        # Heads of 64: every launch served by the narrow D <= 64 instance.
        served = {key: c for key, c in attention.B6_INSTANCES.items() if c}
        assert served == ({attention.b6_instance(dh): n} if n else {}), \
            (what, served)
        out["runs"].append({"run": what, "seconds": dt, "launches": n,
                            "instances": served})
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
    out["b6_instances"] = {attention.b6_instance(dh): out["b6_launches"]}
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
    logit there (gated in the wide-head mode only: at heads of 64 the
    codec's rounding edges turn float32 summing-order differences into
    whole quantization steps)."""
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


def serve_lm(dev, card, wide_splits) -> dict:
    """The attention LM served on the card through ``ServingService`` and
    ``ServingClient`` (see the module's docstring). Each mode's run sets
    every launch count to 0 just before it and reads them just after.
    Modes: continuous paged, drain preallocated, drain paged (float32
    pages); continuous paged and drain paged with int8 pages (B7's int8
    instance); and, on a variant of the workload whose repeated prompt
    reaches into the straddle page of 24-position pages at bucket 128,
    continuous paged without and with the prefix cache; then the same
    widths in ``WIDE_SERVE_HEADS`` heads of 384 (B7's wide instance, 12
    launches an engine step by instance name), continuous paged with
    float32 and with int8 pages, on a few requests; ``wide_splits``
    {(page kind, bucket): splits}, the splits phase 2 held B7 at on the
    wide-head engine's step, which the engine's launches must take."""
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
    wide_cfg = LMConfig(**dict(LM, heads=WIDE_SERVE_HEADS), seed=0)
    wide = dict(cfg=wide_cfg, max_new=WIDE_SERVE_MAX_NEW)
    # (name, runner kwargs, register_runner kwargs, workload, B7 counter
    # [, the LM config and max_new where they are not the main ones])
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
              "paged_decode_attn"),
             ("continuous paged, heads of 384", paged, cont, "wide",
              "paged_decode_attn", wide),
             ("continuous paged int8, heads of 384",
              dict(paged, kv_dtype="int8"), dict(cont, kv_dtype="int8"),
              "wide", "paged_decode_attn_int8", wide))
    workloads = {"main": prompts, "prefix": prefix_prompts,
                 "wide": prompts[:WIDE_SERVE_REQUESTS]}
    wide_dh = LM["dim"] // WIDE_SERVE_HEADS
    tiled = attention.B7_INSTANCE_NAMES[0]
    wide_vec = attention.b7_instance(wide_dh)
    svc = ServingService()
    cli = None
    out = {"modes": {}}
    try:
        runners = []
        for rid, (name, rkw, skw, _, _, *over) in enumerate(modes):
            over = over[0] if over else {}
            runner = AttentionLMRunner(
                params, over.get("cfg", cfg),
                max_new=over.get("max_new", SERVE_MAX_NEW),
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

        for rid, (name, _, _, load, b7, *over) in enumerate(modes):
            over = over[0] if over else {}
            mode_cfg = over.get("cfg", cfg)
            max_new = over.get("max_new", SERVE_MAX_NEW)
            b = svc.batcher(rid)
            mode_prompts = workloads[load]
            h_first = HistWindow("serve.latency.first_token")
            h_per_token = HistWindow("serve.latency.per_token")
            c0 = {k: count(k) for k in (
                "serve.continuous.steps", "serve.batches",
                "serve.prefix.hits", "serve.prefix.prefill_skipped",
                "serve.prefix.copy_on_extend", "serve.continuous.joins")}
            for counts in (rows.LAUNCHES, sgns.LAUNCHES, attention.LAUNCHES,
                           attention.B7_INSTANCES):
                for key in counts:
                    counts[key] = 0
            attention.B7_SPLITS.clear()
            tokens, lat, wall, errors = drive(cli, rid, mode_prompts,
                                              SERVE_IN_FLIGHT)
            launches = dict(attention.LAUNCHES)
            instances = {k: n for k, n in attention.B7_INSTANCES.items()
                         if n}
            split_launches = dict(attention.B7_SPLITS)
            delta = {k: count(k) - v for k, v in c0.items()}
            steps, batches = (delta["serve.continuous.steps"],
                              delta["serve.batches"])
            assert not errors, (name, errors[:3])
            assert all(t is not None and len(t) == max_new
                       for t in tokens), name
            n_tok = max_new * len(mode_prompts)
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
                   "b7_instance_launches": instances,
                   "b6_launches": launches["flash_block_attn"],
                   "heads": mode_cfg.heads}
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
                want = LM["layers"] * (max_new - 1) * batches
            else:
                rec["batches"] = batches
                rec["pipeline_depth"] = b.pipeline_depth
                want = 0
            other = ("paged_decode_attn_int8" if b7 == "paged_decode_attn"
                     else "paged_decode_attn")
            assert (launches[b7] if b7 else 0) == want, (name, rec, want)
            assert b7 is None or launches[other] == 0, (name, launches)
            assert want > 0 or name == "drain preallocated"
            # Every B7 launch by the instance of the mode's heads: the
            # tiled one at heads of 64, the wide one at heads of 384.
            inst = wide_vec if load == "wide" else tiled
            assert instances == ({inst: want} if want else {}), (
                name, instances, want)
            if load == "wide":
                # Each launch with the splits phase 2 held at its bucket,
                # the largest bucket's among them where a prompt needs it.
                kind = "int8" if "int8" in name else "float32"
                held = {b: n for (k, b), n in wide_splits.items()
                        if k == kind}
                assert set(split_launches) <= set(held.values()), (
                    name, split_launches, held)
                if any(len(p) > SERVE_BUCKETS[0] for p in mode_prompts):
                    assert held[SERVE_BUCKETS[-1]] in split_launches, (
                        name, split_launches, held)
                rec["b7_split_launches"] = split_launches
            served[name] = tokens
            if "int8" in name:
                # The int8 modes' logits are not the float32 forward's:
                # their check reads the int8 teacher-forced logits.
                int8_rows[name], off = teacher_forced_int8(
                    lm_params, mode_cfg, mode_prompts, tokens, dev)
                rec["off_int8_teacher_forced"] = off
                if load == "wide":
                    assert off == 0, (name, off)
                base = served["continuous paged" + (
                    ", heads of 384" if load == "wide" else "")]
                same = sum(a == c for x, y in zip(base, tokens)
                           for a, c in zip(x, y))
                rec["share_equal_to_f32_continuous"] = same / n_tok
                if name == "drain paged int8":
                    rec["diverged_at_a_tie"] = agree(
                        served["continuous paged int8"], tokens,
                        int8_rows[name])
            else:
                lg_rows, ties = teacher_forced(lm_params, mode_cfg,
                                               mode_prompts, tokens, dev)
                rec["ties"] = ties
                base = {"main": "continuous paged",
                        "prefix": "continuous paged, prefix workload",
                        "wide": name}[load]
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
                gate = "gated" if load == "wide" else "not gated"
                extra += (f"{rec['off_int8_teacher_forced']} tokens off the "
                          f"int8 teacher-forced argmax beyond TIE_ATOL "
                          f"({gate}), share of tokens equal to continuous "
                          f"paged f32 {rec['share_equal_to_f32_continuous']}")
            if "b7_split_launches" in rec:
                extra += (f"; B7 launches by CTAs a slot and head "
                          f"{rec['b7_split_launches']}")
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
                f"{rec['b7_int8_launches']} (by instance {instances}); "
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


# ---------------------------------------------------------------------------
# phase 8: the rest of the table family, checkpoints, LDA and logreg
# ---------------------------------------------------------------------------
# The device KV table: 1<<20 value slots (a 2^21-bucket directory), rows of
# 50; 10 Adds of 100,000 keys drawn by Zipf rank from 600,000 distinct
# int64 keys over the whole int64 range.
KV_CAPACITY, KV_DIM, KV_UNIVERSE, KV_ADDS = 1 << 20, 50, 600_000, 10
SPARSE_ADDS = 10
# LDA at the scale models/lda.py:91-94 names (lightLDA's word-topic
# table): V = 1,000,000, K = 1,000 (4 GB of float32 counts), a Zipf corpus
# of 2^20 tokens over 10,000 documents, the config's 16,384-token blocks,
# 2 sweeps.
LDA_V, LDA_K, LDA_DOCS, LDA_TOKENS = 1_000_000, 1_000, 10_000, 1 << 20
LDA_BLOCK, LDA_SWEEPS = 16_384, 2
# logreg: one epoch of 20,000 samples at the config's default minibatch
# (20) through PSModel, at MNIST's widths (784 features + bias, 10
# classes, softmax) and at LIBSVM rcv1.binary's (47,236 features, about
# 74 nonzeros a row, FTRL), weights within LR_RTOL / LR_ATOL of a CPU
# replay of the same minibatches (the matrix products sum in other
# orders on the card).
LR_SAMPLES, LR_HELD = 20_000, 2_000
MNIST_FEATURES, MNIST_CLASSES = 784, 10
RCV1_FEATURES, RCV1_NNZ = 47_236, 74
RCV1_FTRL = dict(ftrl_alpha=0.5, ftrl_beta=1.0, ftrl_l1=1e-3, ftrl_l2=1e-3)
LR_RTOL, LR_ATOL = 1e-5, 1e-6


def zipf_ranks(rng, n: int, size: int, s: float = 1.0):
    """``n`` ranks in [0, size) with P(k) proportional to 1 / (k+1)^s."""
    import numpy as np
    p = 1.0 / np.arange(1, size + 1, dtype=np.float64) ** s
    return rng.choice(size, size=n, p=p / p.sum())


def phase8_specs(mv) -> list:
    """The tables of phase 8's first session, in creation order: (name,
    option). The checkpoint's second session makes them again from here."""
    M, K = mv.MatrixTableOption, mv.KVTableOption
    specs = [("sparse", M(ROWS, COLS, is_sparse=True, use_pallas=True,
                          updater="sgd", name="sparse")),
             ("sparse_pipe", M(ROWS, COLS, is_sparse=True, is_pipeline=True,
                               use_pallas=True, updater="sgd",
                               name="sparse_pipe"))]
    for updater in ("default", "adagrad"):
        for dd in (False, True):
            name = f"kv_{updater}_{'dir' if dd else 'host'}"
            specs.append((name, K(device=True, device_directory=dd,
                                  capacity=KV_CAPACITY, value_dim=KV_DIM,
                                  updater=updater, name=name)))
    specs.append(("ckpt_adagrad", M(ROWS, COLS, use_pallas=True,
                                    updater="adagrad", name="ckpt_adagrad")))
    specs.append(("ckpt_bf16", M(ROWS, COLS, dtype="bfloat16",
                                 name="ckpt_bf16")))
    return specs


def sparse_tables(tables, seed: int) -> dict:
    """The sparse matrix table (bench.py:301-313's 1,000,000 x 50, sgd,
    ``use_pallas``) with 2 local workers, and its ``is_pipeline`` twin (4
    slots): worker 1 makes 10 row Adds of 100,000 ids; after each, worker
    0's incremental Get must have exactly the touched rows stale, cross
    them, and leave its cache equal to ``get_rows`` and to the same Adds
    replayed on the CPU; the cache ends bitwise the replayed table."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.core.options import AddOption, GetOption
    from multiverso_tpu_torch.core.table import ServerStore
    from multiverso_tpu_torch.core.updater import get_updater

    rng = np.random.default_rng(seed + 80)
    out = {}
    for name, slots in (("sparse", 2), ("sparse_pipe", 4)):
        t = tables[name]
        assert t.store._pallas_cap == "scatter_sub", t.store._pallas_cap
        assert t._stale.shape == (slots, ROWS), t._stale.shape
        replay = ServerStore(f"replay_{name}", (ROWS, COLS), np.float32,
                             get_updater(np.float32, "sgd"),
                             torch.device("cpu"), num_workers=2,
                             use_pallas_rows=True)
        w0, add1 = GetOption(worker_id=0), AddOption(worker_id=1)
        first = t.get(w0)                    # everything crosses once
        assert not first.any() and len(t.stale_rows(0)) == 0
        t.get_stale(GetOption(worker_id=1))  # and the writer's view
        t0 = time.perf_counter()
        whole = t.get()
        whole_ms = (time.perf_counter() - t0) * 1e3
        assert whole.shape == (ROWS, COLS)
        crossed, inc_ms = [], []
        for _ in range(SPARSE_ADDS):
            ids = rng.integers(0, ROWS, size=N_IDS).astype(np.int32)
            deltas = rng.normal(size=(N_IDS, COLS)).astype(np.float32)
            t.add_rows(ids, deltas, add1)
            replay.apply_rows(ids, deltas, add1)
            touched = np.unique(ids)
            assert np.array_equal(t.stale_rows(0), touched), name
            assert len(t.stale_rows(1)) == 0, name     # the writer's bits
            t0 = time.perf_counter()
            cache = t.get(w0)
            inc_ms.append((time.perf_counter() - t0) * 1e3)
            assert len(t.stale_rows(0)) == 0, name
            crossed.append(len(touched))
            got = t.get_rows(touched)
            assert np.array_equal(cache[touched], got), name
            assert np.array_equal(got, replay.read_rows(touched).numpy()), \
                f"{name}: card rows differ from the CPU replay"
        assert np.array_equal(cache, replay.read().numpy()), name
        out[name] = {"slots": slots, "rows_crossed": crossed,
                     "incremental_get_ms": inc_ms,
                     "whole_table_get_ms": whole_ms}
        log(f"sparse table [{name}, {slots} slots]: {SPARSE_ADDS} x {N_IDS} "
            f"row Adds by worker 1; worker 0's incremental Gets crossed "
            f"{min(crossed)}-{max(crossed)} rows each (exactly the touched "
            f"rows), cache bitwise the CPU replay; incremental Get "
            f"{np.median(inc_ms):.2f} ms median [{min(inc_ms):.2f}-"
            f"{max(inc_ms):.2f}] beside a whole-table Get {whole_ms:.2f} ms")
    return out


def kv_replay_slots(directory, keys):
    """The CPU replay of a device KV table's directory: a dict (the host
    backing) or a ``device_hash`` state on the CPU (the device backing,
    padded as ``DeviceKVTable._resolve_device`` pads). Returns (slots,
    directory)."""
    import numpy as np
    from multiverso_tpu_torch.ops import device_hash
    if isinstance(directory, dict):
        slots = np.empty(len(keys), np.int64)
        for i, k in enumerate(keys.tolist()):
            slots[i] = directory.setdefault(k, len(directory))
        return slots, directory
    padded = 1
    while padded < len(keys):
        padded *= 2
    full = np.concatenate([keys, np.full(padded - len(keys), keys[0])])
    hi, lo = device_hash.split_keys(full)
    directory, slots, overflow = device_hash.insert(directory, hi, lo)
    assert not overflow
    return slots[:len(keys)].numpy(), directory


def device_kv_tables(tables, seed: int) -> dict:
    """The device KV table: 1<<20 slots of 50, default and adagrad
    updaters, host-dict and device directories; 10 Adds of 100,000 Zipf
    int64 keys (negative keys included), then Gets of present and absent
    keys, all bitwise against a CPU replay (the directory through
    ``ops/device_hash`` on the CPU, the slab through a CPU
    ``ServerStore``): the directory's arrays and slots, the slab and its
    state, the payload's ``kv_keys``/``kv_slots``."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.core.options import AddOption
    from multiverso_tpu_torch.core.table import ServerStore
    from multiverso_tpu_torch.core.updater import get_updater
    from multiverso_tpu_torch.ops import device_hash

    rng = np.random.default_rng(seed + 81)
    info = np.iinfo(np.int64)
    universe = np.unique(rng.integers(info.min, info.max, size=KV_UNIVERSE,
                                      dtype=np.int64))
    rng.shuffle(universe)
    assert (universe < 0).any() and (universe > 0).any()
    batches = [(universe[zipf_ranks(rng, N_IDS, len(universe))],
                rng.normal(size=(N_IDS, KV_DIM)).astype(np.float32))
               for _ in range(KV_ADDS)]
    absent = np.setdiff1d(rng.integers(info.min, info.max, size=2_000,
                                       dtype=np.int64), universe)
    present = universe[zipf_ranks(rng, 20_000, len(universe))]
    probe = np.concatenate([present, absent])
    opt = AddOption(learning_rate=0.05, rho=0.1)
    out = {}
    for updater in ("default", "adagrad"):
        for dd in (False, True):
            name = f"kv_{updater}_{'dir' if dd else 'host'}"
            t = tables[name]
            assert t.store.device.type == "cuda" and t._device_dir == dd
            replay = ServerStore(f"replay_{name}", (KV_CAPACITY, KV_DIM),
                                 np.float32, get_updater(np.float32, updater),
                                 torch.device("cpu"), num_workers=2)
            directory = (device_hash.make_state(KV_CAPACITY) if dd else {})
            add_ms, rounds = [], []
            for keys, vals in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t.add(keys, vals, opt)
                torch.cuda.synchronize()
                add_ms.append((time.perf_counter() - t0) * 1e3)
                if dd:
                    rounds.append(dict(device_hash.ROUNDS))
                slots, directory = kv_replay_slots(directory, keys)
                replay.apply_rows(slots, vals, opt)
            t0 = time.perf_counter()
            got = t.get(probe)
            get_ms = (time.perf_counter() - t0) * 1e3
            slots = (np.asarray([directory.get(k, -1) for k in probe.tolist()])
                     if not dd else
                     device_hash.lookup(directory,
                                        *device_hash.split_keys(probe))
                     .numpy())
            want = replay.read_rows(np.maximum(slots, 0)).numpy()
            want[slots < 0] = 0
            assert np.array_equal(got, want), f"{name}: Gets differ"
            assert not got[len(present):].any(), f"{name}: absent keys"
            payload, ref = t.store_state(), replay.store_state()
            for key in ref:
                assert np.array_equal(payload[key], ref[key]), (name, key)
            if dd:
                s = t._dir_state
                for arr in ("k_hi", "k_lo", "slot"):
                    assert torch.equal(getattr(s, arr).cpu(),
                                       getattr(directory, arr)), (name, arr)
                assert s.next_slot == directory.next_slot, name
                occ = directory.slot >= 0
                ref_keys = device_hash.join_keys(directory.k_hi[occ].numpy(),
                                                 directory.k_lo[occ].numpy())
                ref_slots = directory.slot[occ].numpy()
            else:
                ref_keys = np.asarray(list(directory), np.int64)
                ref_slots = np.asarray(list(directory.values()), np.int32)
            assert np.array_equal(payload["kv_keys"], ref_keys), name
            assert np.array_equal(payload["kv_slots"], ref_slots), name
            out[name] = {"keys": len(t), "add_ms": add_ms, "get_ms": get_ms,
                         "probe_rounds": rounds}
            log(f"device KV [{name}]: {KV_ADDS} x {N_IDS} Zipf int64 keys -> "
                f"{len(t)} slots of {KV_CAPACITY}; slab"
                f"{' and state' if updater != 'default' else ''}, payload"
                f"{', directory arrays' if dd else ''} and {len(probe)} Gets "
                f"({len(absent)} absent) bitwise the CPU replay; Add "
                f"{np.median(add_ms):.2f} ms median [{min(add_ms):.2f}-"
                f"{max(add_ms):.2f}], Get {get_ms:.2f} ms"
                + (f"; insert rounds per batch "
                   f"{[r['insert_rounds'] for r in rounds]}, probe steps "
                   f"{[r['probe_steps'] for r in rounds]}" if dd else ""))
    return out


def checkpoint_tables(tables, seed: int) -> None:
    """The checkpoint's extra tables: a ``use_pallas`` adagrad table after
    3 row Adds (B3's fused route, state included) and a bfloat16 table
    after 3 row Adds."""
    import numpy as np
    from multiverso_tpu_torch.core.options import AddOption
    rng = np.random.default_rng(seed + 82)
    opt = AddOption(**STATEFUL_OPT)
    assert tables["ckpt_adagrad"].store._pallas_cap == "fused_stateful"
    for _ in range(3):
        for name in ("ckpt_adagrad", "ckpt_bf16"):
            ids = rng.integers(0, ROWS, size=N_IDS).astype(np.int32)
            deltas = rng.normal(size=(N_IDS, COLS)).astype(np.float32)
            tables[name].add_rows(ids, deltas, opt)


def table_payloads(tables) -> dict:
    """Every table's payload on the host; a KV table's directory as a
    key -> slot dict (a restored device directory holds the same pairs,
    not necessarily in the same buckets)."""
    out = {}
    for name, t in tables.items():
        p = t.store_state() if hasattr(t, "store_state") \
            else t.store.store_state()
        if "kv_keys" in p:
            p["kv_map"] = dict(zip(p.pop("kv_keys").tolist(),
                                   p.pop("kv_slots").tolist()))
        out[name] = p
    return out


def save_and_load(tables, directory: str) -> dict:
    """``save_all`` phase 8's tables, shut down, start again, make fresh
    tables and ``load_all`` them: every payload bitwise, the bfloat16
    file 2 bytes an element, every sparse row stale again. MB and seconds
    of the save and of the load."""
    import numpy as np
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core import checkpoint

    before = table_payloads(tables)
    probe = np.asarray(list(before["kv_adagrad_dir"]["kv_map"])[:1000]
                       + [12345, -12345])
    gets = {name: tables[name].get(probe)
            for name in ("kv_adagrad_dir", "kv_adagrad_host")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    root = checkpoint.save_all(directory, step=8)
    save_s = time.perf_counter() - t0
    mb = sum(os.path.getsize(os.path.join(root, f))
             for f in os.listdir(root)) / 1e6
    with np.load(os.path.join(root, "ckpt_bf16.npz")) as f:
        assert f["data"].dtype == np.uint16, f["data"].dtype
        assert f["data"].nbytes == ROWS * COLS * 2
    mv.shutdown()
    mv.init([], num_local_workers=2)
    fresh = {name: mv.create_table(opt) for name, opt in phase8_specs(mv)}
    t0 = time.perf_counter()
    step = checkpoint.load_all(root)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert step == 8, step
    after = table_payloads(fresh)
    for name, want in before.items():
        got = after[name]
        assert sorted(got) == sorted(want), (name, sorted(got))
        for key in want:
            if key == "kv_map":
                assert got[key] == want[key], name
            else:
                assert np.array_equal(got[key], want[key]), (name, key)
    assert fresh["ckpt_bf16"].store.data.dtype == torch.bfloat16
    for name in ("sparse", "sparse_pipe"):
        assert fresh[name]._stale.all(), name
    for name in ("kv_adagrad_dir", "kv_adagrad_host"):
        assert np.array_equal(fresh[name].get(probe), gets[name]), name
    mv.shutdown()
    log(f"checkpoint: save_all of {len(before)} tables ({mb:.1f} MB) in "
        f"{save_s:.3f} s, load_all into fresh tables after a restart in "
        f"{load_s:.3f} s; every payload bitwise, bfloat16 at 2 bytes an "
        f"element")
    return {"tables": len(before), "mb": mb, "save_s": save_s,
            "load_s": load_s}


def manager_retention(directory: str) -> dict:
    """``CheckpointManager``: a save every step, ``keep_last`` 2; after 5
    steps only the newest 2 checkpoints remain, and ``restore_latest``
    returns the newest step and its values."""
    import numpy as np
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core import checkpoint

    mv.init([])
    t = mv.create_table(mv.ArrayTableOption(size=1024, name="mgr_w"))
    mgr = checkpoint.CheckpointManager(directory, save_every_steps=1,
                                       keep_last=2)
    for step in range(1, 6):
        t.add(np.ones(1024, np.float32))
        assert mgr.maybe_save(step)
    kept = sorted(d for d in os.listdir(directory) if d.startswith("ckpt_"))
    assert kept == ["ckpt_000000000004", "ckpt_000000000005"], kept
    t.add(np.full(1024, 100.0, np.float32))
    step = mgr.restore_latest()
    assert step == 5, step
    assert np.array_equal(t.get(), np.full(1024, 5.0, np.float32))
    mv.shutdown()
    log(f"checkpoint manager: keep_last 2 kept {kept}; restore_latest -> "
        f"step {step}")
    return {"kept": kept, "restored_step": step}


def lda_corpus(seed: int):
    """2^20 tokens over 10,000 documents (lengths from the seed), words by
    Zipf rank over V = 1,000,000."""
    import numpy as np
    rng = np.random.default_rng(seed + 83)
    words = zipf_ranks(rng, LDA_TOKENS, LDA_V).astype(np.int64)
    cuts = np.sort(rng.choice(np.arange(1, LDA_TOKENS), size=LDA_DOCS - 1,
                              replace=False))
    docs = np.repeat(np.arange(LDA_DOCS), np.diff(
        np.concatenate([[0], cuts, [LDA_TOKENS]])))
    return words, docs


def lda_phase(seed: int) -> dict:
    """LDA at V = 1,000,000, K = 1,000 on the card: the first block's
    sampled topics equal a CPU replay of the Gibbs step on the same pulled
    counts and the same Gumbel noise; then 2 sweeps of ``LDA.train``; the
    word-topic rows sum to each word's token count, the topic totals are
    the table's column sums, the doc-topic rows sum to each document's
    length, every count is non-negative."""
    import numpy as np
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models.lda import LDA, LDAConfig, gibbs_step

    words, docs = lda_corpus(seed)
    mv.init([])
    cfg = LDAConfig(num_topics=LDA_K, iterations=LDA_SWEEPS,
                    block_tokens=LDA_BLOCK, seed=seed)
    lda = LDA(cfg, num_docs=LDA_DOCS, vocab_size=LDA_V)
    assert lda.device.type == "cuda"
    assert lda.word_topic.store.data.numel() * 4 == 4 * LDA_V * LDA_K
    t0 = time.perf_counter()
    topics = lda.init_assignments(words, docs)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dev = lda.device
    w = torch.as_tensor(words[:LDA_BLOCK], device=dev)
    d = torch.as_tensor(docs[:LDA_BLOCK], device=dev)
    _, _, n_wk, n_k, n_dk = lda.block_counts(w, d)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 84)
    u = torch.rand((LDA_BLOCK, LDA_K), generator=gen, device=dev)
    noise = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
    t_blk = topics[:LDA_BLOCK]
    card = gibbs_step(n_wk, n_k, n_dk, t_blk, noise, LDA_V, cfg.alpha,
                      cfg.beta)
    cpu = gibbs_step(n_wk.cpu(), n_k.cpu(), n_dk.cpu(), t_blk.cpu(),
                     noise.cpu(), LDA_V, cfg.alpha, cfg.beta)
    differ = int((card.cpu() != cpu).sum())
    assert differ == 0, f"LDA first block: {differ} topics differ"
    del n_wk, n_dk, u, noise
    stats = lda.train(words, docs, topics=topics)
    wt = lda.word_topic.store.data
    counts = torch.bincount(torch.as_tensor(words, device=dev),
                            minlength=LDA_V)
    assert torch.equal(wt.sum(dim=1, dtype=torch.float64),
                       counts.to(torch.float64)), "word-topic row sums"
    assert torch.equal(lda.topic.raw().double(),
                       wt.sum(dim=0, dtype=torch.float64)), "topic totals"
    lengths = torch.bincount(torch.as_tensor(docs, device=dev),
                             minlength=LDA_DOCS)
    assert torch.equal(lda.doc_topic.sum(dim=1, dtype=torch.float64),
                       lengths.to(torch.float64)), "doc-topic row sums"
    assert bool((wt >= 0).all()) and bool((lda.doc_topic >= 0).all())
    assert bool((lda.topic.raw() >= 0).all())
    assert int(lda.topic.raw().sum()) == LDA_TOKENS
    vocab = int((counts > 0).sum())
    mv.shutdown()
    log(f"LDA: V={LDA_V}, K={LDA_K} (word-topic table "
        f"{LDA_V * LDA_K * 4 / 1e9:.1f} GB on the card), {LDA_TOKENS} tokens ({vocab} distinct words) "
        f"over {LDA_DOCS} docs, blocks of {LDA_BLOCK}: the first block's "
        f"topics equal the CPU replay's with the same Gumbel noise; "
        f"{LDA_SWEEPS} sweeps at {stats['tokens_per_sec']:.6g} tokens/sec "
        f"({stats['seconds']:.3f} s; seeding the tables {init_s:.3f} s); "
        f"counts conserved and non-negative")
    return {"tokens_per_sec": stats["tokens_per_sec"],
            "seconds": stats["seconds"], "init_s": init_s,
            "distinct_words": vocab, "blocks": lda.blocks}


def mnist_like(seed: int):
    """Dense samples at MNIST's widths: 784 pixels in [0, 1), about 19%
    of them lit, labels of a planted linear model over 10 classes."""
    import numpy as np
    rng = np.random.default_rng(seed + 85)
    n = LR_SAMPLES
    X = ((rng.random((n, MNIST_FEATURES)) < 0.19)
         * rng.random((n, MNIST_FEATURES))).astype(np.float32)
    W = rng.normal(size=(MNIST_FEATURES, MNIST_CLASSES))
    y = (X @ W).argmax(axis=1).astype(np.float32)
    return X, y


def write_rcv1_like(path: str, seed: int) -> None:
    """A libsvm file at rcv1.binary's width: 47,236 features, 74 distinct
    nonzeros a row on average (Poisson), L2-normalised positive values as
    its TF-IDF rows are, labels of a planted sparse linear model."""
    import numpy as np
    rng = np.random.default_rng(seed + 86)
    w = rng.normal(size=RCV1_FEATURES)
    lines = []
    for _ in range(LR_SAMPLES):
        idx = np.unique(rng.integers(0, RCV1_FEATURES,
                                     size=max(1, rng.poisson(RCV1_NNZ))))
        val = rng.random(len(idx)) + 0.1
        val /= np.linalg.norm(val)
        label = int(val @ w[idx] > 0)
        lines.append(f"{label} " + " ".join(
            f"{i}:{v:.6f}" for i, v in zip(idx.tolist(), val.tolist())))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def logreg_run(cfg_kw: dict, batches, held) -> dict:
    """One epoch through ``LogReg`` with a ``PSModel`` on the Zoo's device;
    the loss on ``held`` (X, y) before and after."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.models.logreg import LogReg, LogRegConfig
    from multiverso_tpu_torch.models.logreg.model import PSModel, make_step

    cfg = LogRegConfig(**cfg_kw)
    lr = LogReg(cfg)
    assert isinstance(lr.model, PSModel)
    step = make_step(cfg)
    dev = lr.device
    Xh = torch.as_tensor(held[0], device=dev)
    yh = torch.as_tensor(held[1], device=dev)
    zero = torch.zeros((cfg.width, cfg.num_class), device=dev)
    before = float(step(zero, Xh, yh)[0])
    t0 = time.perf_counter()
    losses = lr.train(batches, epochs=1)
    seconds = time.perf_counter() - t0
    weights = np.array(lr.model.get_weights())
    after = float(step(torch.as_tensor(weights, device=dev), Xh, yh)[0])
    return {"weights": weights, "epoch_loss": losses[0], "before": before,
            "after": after, "seconds": seconds,
            "samples_per_sec": LR_SAMPLES / seconds}


def logreg_phase(seed: int, directory: str) -> dict:
    """logreg at MNIST's widths (softmax) and at rcv1.binary's (FTRL, from
    a libsvm file through ``SampleReader``): one epoch of 20,000 samples
    through ``PSModel`` on the card, then the same on the CPU; finite
    losses, a falling loss on 2,000 of the samples, weights within
    LR_RTOL / LR_ATOL of the CPU replay."""
    import numpy as np
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models.logreg import ArrayBatcher, SampleReader

    X, y = mnist_like(seed)
    Xb = np.concatenate([X, np.ones((len(X), 1), np.float32)], axis=1)
    path = os.path.join(directory, "rcv1_like.svm")
    t0 = time.perf_counter()
    write_rcv1_like(path, seed)
    write_s = time.perf_counter() - t0
    rcv1_held = next(iter(SampleReader(path, RCV1_FEATURES, LR_HELD,
                                       prefetch=False)))
    configs = {
        "mnist_softmax": (dict(objective="softmax",
                               num_feature=MNIST_FEATURES,
                               num_class=MNIST_CLASSES),
                          lambda cfg: ArrayBatcher(X, y, 20),
                          (Xb[:LR_HELD], y[:LR_HELD])),
        "rcv1_ftrl": (dict(objective="ftrl", num_feature=RCV1_FEATURES,
                           **RCV1_FTRL),
                      lambda cfg: SampleReader(path, RCV1_FEATURES, 20),
                      rcv1_held)}
    out = {}
    for name, (kw, batches, held) in configs.items():
        runs = {}
        for platform in ("cuda", "cpu"):
            # Named each time: the flags outlive mv.shutdown(), so the CPU
            # replay's -platform=cpu would otherwise carry into the next
            # card run (it did, for rcv1, before this was named).
            mv.init([f"-platform={platform}"])
            assert (mv.get_flag("platform") == "cpu") == (platform == "cpu")
            runs[platform] = logreg_run(kw, batches(kw), held)
            mv.shutdown()
        mv.set_flag("platform", "")
        card, cpu = runs["cuda"], runs["cpu"]
        for r in runs.values():
            assert np.isfinite([r["epoch_loss"], r["before"],
                                r["after"]]).all(), (name, r)
            assert r["after"] < r["before"], (name, r["before"], r["after"])
        err = np.abs(card["weights"] - cpu["weights"])
        ok = err <= LR_ATOL + LR_RTOL * np.abs(cpu["weights"])
        assert bool(ok.all()), (name, float(err.max()))
        out[name] = {k: v for k, v in card.items() if k != "weights"}
        out[name]["max_abs_err_vs_cpu"] = float(err.max())
        out[name]["cpu_samples_per_sec"] = cpu["samples_per_sec"]
        log(f"logreg [{name}]: 1 epoch of {LR_SAMPLES} samples at minibatch "
            f"20 through PSModel: {card['samples_per_sec']:.6g} samples/sec "
            f"on the card ({cpu['samples_per_sec']:.6g} on the CPU); epoch "
            f"loss {card['epoch_loss']:.5f}, held loss {card['before']:.5f} "
            f"-> {card['after']:.5f}; weights within rtol {LR_RTOL} / atol "
            f"{LR_ATOL} of the CPU replay (max |err| {err.max():.3e})")
    out["rcv1_file_write_s"] = write_s
    return out


def phase8(seed: int, on_path, card: str) -> dict:
    """Phase 8: the sparse matrix table, the device KV table, npz
    checkpoints across a restart, LDA and logreg, each at full width on
    the card. Returns the readings and the kernel launches of each run."""
    import multiverso_tpu_torch as mv
    log(f"phase 8 on {card}")
    out = {"launches": {}}
    mv.init([], num_local_workers=2)
    tables = {name: mv.create_table(opt) for name, opt in phase8_specs(mv)}
    out["sparse"], out["launches"]["sparse"] = on_path(
        sparse_tables, tables, seed)
    out["device_kv"], out["launches"]["device_kv"] = on_path(
        device_kv_tables, tables, seed)
    _, out["launches"]["checkpoint_tables"] = on_path(
        checkpoint_tables, tables, seed)
    with tempfile.TemporaryDirectory() as tmp:      # phase 9 (c)
        out["async_checkpoint"] = async_checkpoint(tables, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        out["checkpoint"] = save_and_load(tables, tmp)
    del tables
    with tempfile.TemporaryDirectory() as tmp:
        out["checkpoint_manager"] = manager_retention(tmp)
    out["lda"], out["launches"]["lda"] = on_path(lda_phase, seed)
    with tempfile.TemporaryDirectory() as tmp:
        out["logreg"] = logreg_phase(seed, tmp)
    return out


# ---------------------------------------------------------------------------
# phase 9: the lookup serving plane, the async checkpoint, DLRM online
# ---------------------------------------------------------------------------
# Live lookups: serve_bench's lookup shape (8 keys a request, buckets
# 8-64, max batch 8) with Zipf(1.2) keys over bench.py:301-313's table.
LOOKUP_KEYS, LOOKUP_BUCKETS, LOOKUP_BATCH = 8, (8, 16, 32, 64), 8
LOOKUP_REQUESTS, LOOKUP_BURSTS, LOOKUP_IN_FLIGHT = 2_000, 10, 16
LOOKUP_ZIPF, LOOKUP_CACHE_ROWS = 1.2, 8_192
REPLICA_REQUESTS = 600
# DLRM at the published Criteo Kaggle widths of facebookresearch/dlrm
# bench/dlrm_s_criteo_kaggle.sh (26 sparse fields, 13 dense features,
# embedding 16, bottom MLP 512-256-64 then 16, top MLP 512-256 then 1,
# mini-batch 128), each field's vocabulary cut to 100,000 ids (Kaggle's
# largest tables hold ~10M).
DLRM_WIDTHS = dict(fields=26, vocab=100_000, embed_dim=16, dense_dim=13,
                   bottom_mlp=(512, 256, 64), top_mlp=(512, 256))
DLRM_BATCH, DLRM_STEPS, DLRM_PUBLISH, DLRM_EVAL = 128, 240, 40, 4
DLRM_LANES, DLRM_PARITY_STEPS, DLRM_SERVE_QPS = (1, 4), 20, 400.0
DLRM_SERVE_CHECKS = 64
# Card against a CPU replay of the same 20 steps, float32 products in full
# float32 (no TF32): for each dense parameter and each embedding table,
# max |card - replay| over max |replay - initial value| (float32 matrix
# products and reductions sum in other orders on the card; the AdaGrad
# steps carry the differences on). A card twin with TF32 switched on must
# exceed it.
DLRM_RTOL = 5e-4


def lookup_burst(cli, queries, in_flight: int, runner_id: int = 0):
    """Send every query over ``cli`` with ``in_flight`` outstanding;
    returns (values, reply clocks, request latencies in ms, wall s)."""
    import queue
    import threading

    todo = queue.Queue()
    for i in range(len(queries)):
        todo.put(i)
    values = [None] * len(queries)
    clocks = [None] * len(queries)
    lat = [0.0] * len(queries)
    errors = []

    def worker():
        while True:
            try:
                i = todo.get_nowait()
            except queue.Empty:
                return
            t0 = time.perf_counter()
            try:
                values[i], clocks[i] = cli.request_async(
                    queries[i], 60_000, runner_id).wait(120)
            except Exception as e:  # noqa: BLE001 - counted, then failed
                errors.append((i, repr(e)))
            lat[i] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=worker) for _ in range(in_flight)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "a lookup client thread hung"
    assert not errors, errors[:3]
    return values, clocks, lat, time.perf_counter() - t0


def zipf_queries(rng, n: int, rows: int):
    from multiverso_tpu_torch.models.dlrm.stream import zipf_ids
    return list(zipf_ids(rng, LOOKUP_ZIPF, n * LOOKUP_KEYS, rows)
                .reshape(n, LOOKUP_KEYS))


def live_lookups(seed: int) -> dict:
    """(a) Live lookups in sync mode (2 local workers): the 1,000,000 x
    50 ``use_pallas`` sgd table after 10 row Adds of 100,000 ids (5 BSP
    rounds of both workers), served through ``serving_runner`` with a
    ``HotRowCache`` of 8,192 rows at staleness 0 behind ``ServingService``
    and ``ServingClient``: 2,000 requests of 8 Zipf(1.2) keys in 10 bursts
    with a round of Adds between bursts. Every reply must be bitwise the
    table's rows at the clock it is stamped with."""
    import numpy as np
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core.options import AddOption
    from multiverso_tpu_torch.serving import (HotRowCache, ServingClient,
                                              ServingService)
    from multiverso_tpu_torch.telemetry import get_registry

    rng = np.random.default_rng(seed + 90)
    mv.init(["-sync=true"], num_local_workers=2)
    t = mv.create_table(mv.MatrixTableOption(ROWS, COLS, use_pallas=True,
                                             updater="sgd", name="live"))
    assert t.store.device.type == "cuda", t.store.device

    def add_round():
        for w in (0, 1):
            ids = rng.integers(0, ROWS, size=N_IDS).astype(np.int32)
            t.add_rows(ids, rng.normal(size=(N_IDS, COLS)).astype(
                np.float32), AddOption(worker_id=w))

    for _ in range(5):
        add_round()
    runner = t.serving_runner(cache=HotRowCache(LOOKUP_CACHE_ROWS, 0))
    svc = ServingService()
    svc.register_runner(runner, buckets=LOOKUP_BUCKETS,
                        max_batch=LOOKUP_BATCH, max_wait_ms=2.0,
                        max_queue=64)
    cli = ServingClient(*svc.address)
    reg = get_registry()
    hits0 = reg.counter("serve.cache.hit").value
    per = LOOKUP_REQUESTS // LOOKUP_BURSTS
    lat, wall, clocks_seen = [], 0.0, set()
    try:
        for burst in range(LOOKUP_BURSTS):
            clock = runner.current_clock()
            table = t.store.read().cpu().numpy()
            queries = zipf_queries(rng, per, ROWS)
            vals, clocks, ms, secs = lookup_burst(cli, queries,
                                                  LOOKUP_IN_FLIGHT)
            for q, v, c in zip(queries, vals, clocks):
                assert c == clock, (c, clock)
                assert np.array_equal(v, table[q]), \
                    "a live lookup differs from the table at its clock"
            clocks_seen.add(clock)
            lat += ms
            wall += secs
            if burst + 1 < LOOKUP_BURSTS:
                add_round()
    finally:
        cli.close()
        svc.close()
    hits = reg.counter("serve.cache.hit").value - hits0
    assert len(clocks_seen) == LOOKUP_BURSTS, clocks_seen
    assert hits > 0, "the hot-row cache never answered"
    out = {"requests": LOOKUP_REQUESTS, "requests_per_sec":
           LOOKUP_REQUESTS / wall, "p50_ms": pct(lat, 50),
           "p99_ms": pct(lat, 99), "cache_hits": hits,
           "clocks": sorted(clocks_seen)}
    log(f"live lookups: {LOOKUP_REQUESTS} requests of {LOOKUP_KEYS} Zipf"
        f"({LOOKUP_ZIPF}) keys over {ROWS:,} x {COLS} in {LOOKUP_BURSTS} "
        f"bursts at clocks {out['clocks'][0]:.0f}-{out['clocks'][-1]:.0f}, "
        f"every reply bitwise the table at its stamped clock: "
        f"{out['requests_per_sec']:.1f} requests/sec, p50 "
        f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms, {hits} cache "
        f"hits")
    out["table"] = t
    return out


def replica_lookups(live: dict, seed: int, directory: str) -> dict:
    """(b) The live table checkpointed (npz), then served through
    ``CheckpointReplica`` + ``ReplicaLookupRunner`` at f32, bf16 and int8
    (one service, three runners): f32 replies bitwise the checkpoint's
    rows, bf16/int8 within ``roundtrip_bound`` of them and bitwise the
    CPU replay of the decode gather; the f32 replica hot-swaps to a newer
    checkpoint while requests run (each reply the bytes of the step it is
    stamped with; every request after the swap the new bytes); then a
    ``RoutedLookupClient`` over two services, each holding half the rows
    by ``row_offset``, returns the whole table's rows bitwise."""
    import threading
    import numpy as np
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core import checkpoint
    from multiverso_tpu_torch.core.options import AddOption
    from multiverso_tpu_torch.serving import (CheckpointReplica,
                                              ReplicaLookupRunner,
                                              RoutedLookupClient,
                                              ServingClient, ServingService,
                                              SparseLookupRunner, quant)
    from multiverso_tpu_torch.serving.runners import _dequant_gather

    rng = np.random.default_rng(seed + 91)
    t = live.pop("table")
    checkpoint.save_all(directory, step=1)
    data = {1: t.store.read().cpu().numpy()}
    reps = {d: CheckpointReplica(directory, table_dtype=d)
            for d in ("f32", "bf16", "int8")}
    assert all(r.device.type == "cuda" for r in reps.values())
    svc = ServingService()
    for rid, d in enumerate(reps):
        svc.register_runner(ReplicaLookupRunner(reps[d], "live"),
                            runner_id=rid, buckets=LOOKUP_BUCKETS,
                            max_batch=LOOKUP_BATCH, max_wait_ms=2.0)
    cli = ServingClient(*svc.address)
    out = {}
    try:
        for rid, d in enumerate(reps):
            queries = zipf_queries(rng, REPLICA_REQUESTS, ROWS)
            vals, clocks, ms, secs = lookup_burst(cli, queries,
                                                  LOOKUP_IN_FLIGHT, rid)
            assert set(clocks) == {1}, set(clocks)
            bound = quant.roundtrip_bound(data[1], d)
            err = 0.0
            if d != "f32":
                pay, scale = quant.encode_table(data[1], d,
                                                torch.device("cpu"))
            for q, v in zip(queries, vals):
                want = data[1][q]
                if d == "f32":
                    assert np.array_equal(v, want), "f32 replica lookup"
                    continue
                err = max(err, float(np.abs(v - want).max()))
                replay = _dequant_gather(pay, scale, torch.as_tensor(q))
                assert np.array_equal(v, replay.numpy()), \
                    f"{d} replica lookup differs from the CPU decode"
            assert err <= bound, (d, err, bound)
            out[d] = {"requests_per_sec": REPLICA_REQUESTS / secs,
                      "p50_ms": pct(ms, 50), "p99_ms": pct(ms, 99),
                      "max_abs_err": err, "bound": bound}
            log(f"replica lookups [{d}]: {REPLICA_REQUESTS} requests, "
                f"{out[d]['requests_per_sec']:.1f} requests/sec, p50 "
                f"{out[d]['p50_ms']:.3f} ms, p99 {out[d]['p99_ms']:.3f} ms; "
                f"max |reply - checkpoint| {err:.3g} (bound {bound:.3g})")

        # Hot swap mid-run: a newer checkpoint lands while requests run.
        for w in (0, 1):
            ids = rng.integers(0, ROWS, size=N_IDS).astype(np.int32)
            t.add_rows(ids, rng.normal(size=(N_IDS, COLS)).astype(
                np.float32), AddOption(worker_id=w))
        checkpoint.save_all(directory, step=2)
        data[2] = t.store.read().cpu().numpy()
        swapper = threading.Timer(0.05, reps["f32"].refresh)
        swapper.start()
        queries = zipf_queries(rng, REPLICA_REQUESTS, ROWS)
        vals, during, _, _ = lookup_burst(cli, queries, LOOKUP_IN_FLIGHT, 0)
        swapper.join()
        assert reps["f32"].step == 2
        for q, v, c in zip(queries, vals, during):
            assert np.array_equal(v, data[c][q]), (c, "torn swap")
        queries = zipf_queries(rng, 200, ROWS)
        vals, clocks, _, _ = lookup_burst(cli, queries, LOOKUP_IN_FLIGHT, 0)
        assert set(clocks) == {2}
        for q, v in zip(queries, vals):
            assert np.array_equal(v, data[2][q]), "stale after the swap"
        out["swap"] = {"old_step_replies": during.count(1),
                       "new_step_replies": during.count(2)}
        log(f"replica hot swap while {REPLICA_REQUESTS} requests ran: "
            f"{during.count(1)} replies of step 1, {during.count(2)} of "
            f"step 2, each the bytes of its step; the next 200 all step 2")
    finally:
        cli.close()
        svc.close()
        for r in reps.values():
            r.close()

    # Two services, each over half the rows by row_offset.
    half = ROWS // 2
    halves, svcs = [], []
    for lo in (0, half):
        h = mv.create_table(mv.MatrixTableOption(half, COLS, use_pallas=True,
                                                 name=f"half{lo}"))
        h.publish(data[2][lo:lo + half])
        s = ServingService()
        s.register_runner(SparseLookupRunner(h.store, row_offset=lo),
                          buckets=LOOKUP_BUCKETS, max_batch=LOOKUP_BATCH,
                          max_wait_ms=2.0)
        halves.append(h)
        svcs.append(s)
    routed = RoutedLookupClient([s.address for s in svcs],
                                offsets=[0, half, ROWS])
    try:
        for _ in range(200):
            q = rng.integers(0, ROWS, LOOKUP_KEYS)
            assert np.array_equal(routed.lookup(q, deadline_ms=60_000),
                                  data[2][q]), "routed lookup"
    finally:
        routed.close()
        for s in svcs:
            s.close()
    mv.shutdown()
    log(f"routed lookups: 200 requests over two half-table services "
        f"(row_offset 0 and {half:,}), bitwise the whole table")
    return out


def async_checkpoint(tables, directory: str) -> dict:
    """(c) Phase 8's tables saved by the async backend
    (``CheckpointManager(backend="orbax")``) twice; right after each
    ``maybe_save`` returns, 3 in-place row Adds into the ``use_pallas``
    adagrad table (the fused route) and the sgd sparse table (B2). The
    loaded checkpoint must be bitwise the snapshot before those Adds.
    Seconds from the call to its return (staged) and to the commit (the
    whole write), the first save with fresh pinned buffers, the second
    reusing them."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.core import checkpoint
    from multiverso_tpu_torch.core.options import AddOption

    rng = np.random.default_rng(84)
    mgr = checkpoint.CheckpointManager(directory, save_every_steps=1,
                                       keep_last=1, backend="orbax")
    readings = []
    for step in (1, 2):
        before = table_payloads(tables)
        torch.cuda.synchronize()
        root = mgr.maybe_save(step)
        for _ in range(3):
            ids = rng.integers(0, ROWS, size=N_IDS).astype(np.int32)
            d = rng.normal(size=(N_IDS, COLS)).astype(np.float32)
            tables["ckpt_adagrad"].add_rows(ids, d,
                                            AddOption(**STATEFUL_OPT))
            tables["sparse"].add_rows(ids, d, AddOption(worker_id=1))
        mgr.finalize()
        h = mgr.last_handle
        mb = sum(os.path.getsize(os.path.join(dp, f))
                 for dp, _, fs in os.walk(root) for f in fs) / 1e6
        readings.append({"step": step, "staged_s": h.staged_s,
                         "total_s": h.total_s, "mb": mb})
        saved = {name: before[name] for name in ("ckpt_adagrad", "sparse",
                                                 "ckpt_bf16")}
        assert mgr.restore_latest() == step
        after = table_payloads(tables)
        for name, want in saved.items():
            for key in want:
                assert np.array_equal(after[name][key], want[key]), \
                    (name, key, "an Add after maybe_save reached the save")
        log(f"async checkpoint [save {step}]: {len(tables)} tables "
            f"({mb:.1f} MB) staged in {h.staged_s:.3f} s, written and "
            f"committed in {h.total_s:.3f} s; the Adds issued after "
            f"maybe_save returned are absent from the restored tables")
    return {"saves": readings,
            "pinned_mb": mgr._staging.nbytes / 1e6}


def moved_err(card, host, init) -> float:
    """max |card - host| over max |host - init| of one tensor (how far
    the card is from the replay, against how far the replay moved)."""
    import numpy as np
    card, host, init = (np.asarray(x.cpu() if hasattr(x, "cpu") else x,
                                   dtype=np.float64)
                        for x in (card, host, init))
    return float(np.abs(card - host).max() / np.abs(host - init).max())


def dlrm_parity(seed: int) -> dict:
    """(d, first part) At the Criteo Kaggle widths: a PS model and its
    local twin on the card, 20 steps on one impression stream, bitwise
    equal (dense params, every embedding table and AdaGrad state, every
    loss and score). Every push of the PS model (128 lanes x 16 columns a
    field) is sorted and folded again by the fold kernel, bitwise its
    plain version on the CPU copies. A local model on the CPU replays the
    same steps: each of the card's dense params and embedding tables must
    be within DLRM_RTOL of it by ``moved_err``, and a local twin on the
    card with TF32 switched on must exceed DLRM_RTOL. Only the PS and
    local steps count as the path's launches."""
    import numpy as np
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models.dlrm import (DLRMConfig, DLRMModel,
                                                  ImpressionStream,
                                                  StreamConfig)
    from multiverso_tpu_torch.ops import rows

    cfg = DLRMConfig(**DLRM_WIDTHS, seed=seed)
    scfg = StreamConfig(fields=cfg.fields, vocab=cfg.vocab,
                        dense_dim=cfg.dense_dim, zipf=1.2, seed=seed)
    mv.init([])
    models = {"ps": DLRMModel(cfg, mode="ps"),
              "local": DLRMModel(cfg, mode="local"),
              "cpu": DLRMModel(cfg, mode="local",
                               device=torch.device("cpu"))}
    assert models["ps"].device.type == "cuda" == models["local"].device.type
    pushes = []
    push = models["ps"]._push_rows

    def keep_push(f, ids, delta):
        pushes.append((ids.clone(), delta.clone()))
        push(f, ids, delta)

    models["ps"]._push_rows = keep_push
    streams = {k: ImpressionStream(scfg) for k in models}
    folds0 = rows.LAUNCHES["fold_sorted_runs"]
    for i in range(DLRM_PARITY_STEPS):
        got = {}
        for k in ("ps", "local"):
            b = streams[k].batch(DLRM_BATCH)
            got[k] = models[k].step(b.ids, b.dense, b.labels)
        assert got["ps"][0] == got["local"][0], (i, got["ps"][0],
                                                 got["local"][0])
        assert np.array_equal(got["ps"][1], got["local"][1]), i
    folds = rows.LAUNCHES["fold_sorted_runs"] - folds0
    assert folds == 2 * cfg.fields * DLRM_PARITY_STEPS, folds
    path_counts = dict(rows.LAUNCHES)

    # The fold kernel at DLRM's shape, on every push the PS model made.
    dup_lanes = 0
    for ids, delta in pushes:
        sid, order = torch.sort(ids, stable=True)
        sd = delta.index_select(0, order)
        assert torch.equal(rows.fold_sorted_runs(sid, sd).cpu(),
                           rows.fold_sorted_runs_plain(sid.cpu(), sd.cpu()))
        dup_lanes += int((sid[1:] == sid[:-1]).sum())
    assert len(pushes) == cfg.fields * DLRM_PARITY_STEPS and dup_lanes > 0

    # The CPU replay, and a card twin with TF32 switched on.
    cpu = models["cpu"]
    init = {"dense": [(w.clone(), b.clone()) for w, b in cpu.dense_params],
            "emb": [cpu.local_rows(f).copy() for f in range(cfg.fields)]}
    for _ in range(DLRM_PARITY_STEPS):
        b = streams["cpu"].batch(DLRM_BATCH)
        cpu.step(b.ids, b.dense, b.labels)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        models["tf32"] = DLRMModel(cfg, mode="local")
        stream = ImpressionStream(scfg)
        for _ in range(DLRM_PARITY_STEPS):
            b = stream.batch(DLRM_BATCH)
            models["tf32"].step(b.ids, b.dense, b.labels)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    rows.LAUNCHES.update(path_counts)

    ps, local, tf32 = models["ps"], models["local"], models["tf32"]
    for (w, b), (wl, bl) in zip(ps.dense_params, local.dense_params):
        assert torch.equal(w, wl) and torch.equal(b, bl)
    for f in range(cfg.fields):
        t = ps.tables[f].store
        assert torch.equal(t.data, local._emb[f]), f
        assert torch.equal(t.state["g2"], local._emb_state[f]["g2"]), f
    err = {}
    for name, model, rows_of in (
            ("card", ps, lambda f: ps.tables[f].store.data),
            ("tf32", tf32, lambda f: tf32._emb[f])):
        err[name] = {
            "dense": max(moved_err(c, h, i)
                         for cw, hw, iw in zip(model.dense_params,
                                               cpu.dense_params,
                                               init["dense"])
                         for c, h, i in zip(cw, hw, iw)),
            "emb": max(moved_err(rows_of(f), cpu.local_rows(f),
                                 init["emb"][f])
                       for f in range(cfg.fields))}
    mv.shutdown()
    log(f"DLRM parity: {DLRM_PARITY_STEPS} steps at the Criteo Kaggle "
        f"widths, PS and local twin bitwise on the card ({folds} fold "
        f"launches); the fold kernel bitwise its plain version on all "
        f"{len(pushes)} pushes ({DLRM_BATCH} x {cfg.embed_dim}, "
        f"{dup_lanes} lanes in runs of more than one); card against the "
        f"CPU replay, of how far the replay moved: dense "
        f"{err['card']['dense']:.3g}, embeddings {err['card']['emb']:.3g} "
        f"(limit {DLRM_RTOL}); the TF32 twin: dense "
        f"{err['tf32']['dense']:.3g}, embeddings {err['tf32']['emb']:.3g}")
    assert max(err["card"].values()) <= DLRM_RTOL, err
    assert max(err["tf32"].values()) > DLRM_RTOL, \
        ("the tolerance cannot tell TF32 from float32", err)
    return {"steps": DLRM_PARITY_STEPS, "fold_launches": folds,
            "fold_checked_pushes": len(pushes), "dup_lanes": dup_lanes,
            "card_vs_cpu": err["card"], "tf32_vs_cpu": err["tf32"]}


def dlrm_online(seed: int, directory: str) -> dict:
    """(d) The online loop at the Criteo Kaggle widths: 240 steps of 128
    impressions, a publish (npz checkpoint + replica swap) every 40,
    freshness lanes 1 and 4, with ``ServeLoad`` driving Zipf lookups of
    16 keys into field 0's live table (a hot-row cache of 8,192 rows at
    staleness 1) at a paced 400 requests/sec; then the final checkpoint
    scored through an f32 and an int8 replica on 4 held-out batches.
    Every served lookup answered; the fresh lane's AUC at least the
    frozen lane's; once training stops, 64 batches of ``ServeLoad``'s
    shape through its runner (B1 over 16-wide rows) bitwise the plain
    gather of the table on the CPU. The loop's time split between steps,
    publishes and the rest from the ``recsys.*`` histograms."""
    import numpy as np
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models.dlrm.stream import zipf_ids
    from multiverso_tpu_torch.ops import rows
    from multiverso_tpu_torch.telemetry import get_registry
    from multiverso_tpu_torch.models.dlrm import (DLRMConfig, DLRMModel,
                                                  ImpressionStream,
                                                  SnapshotScorer,
                                                  StreamConfig, exact_auc)
    from multiverso_tpu_torch.recsys import (OnlineConfig, OnlineLoop,
                                             ServeLoad, make_live_runner)
    from multiverso_tpu_torch.serving import CheckpointReplica

    cfg = DLRMConfig(**DLRM_WIDTHS, seed=seed)
    scfg = StreamConfig(fields=cfg.fields, vocab=cfg.vocab,
                        dense_dim=cfg.dense_dim, zipf=1.2,
                        drift_scale=0.3, seed=seed)
    mv.init([])
    model = DLRMModel(cfg, mode="ps")
    assert model.device.type == "cuda", model.device
    stream = ImpressionStream(scfg)
    loop = OnlineLoop(model, stream, directory, OnlineConfig(
        steps=DLRM_STEPS, batch=DLRM_BATCH, publish_every=DLRM_PUBLISH,
        eval_every=DLRM_EVAL, lanes=DLRM_LANES))
    load = ServeLoad(make_live_runner(model, field=0, cache_rows=8_192,
                                      cache_staleness=1),
                     vocab=cfg.vocab, qps=DLRM_SERVE_QPS, keys_per_req=16,
                     max_batch=8, seed=seed + 7).start()
    hists = {k: get_registry().histogram(f"recsys.{k}") for k in
             ("train.step_ms", "publish.latency_ms")}
    before = {k: (h.count, h.sum) for k, h in hists.items()}
    try:
        summary = loop.run()
    finally:
        serve = load.stop()
    split = {k: {"count": h.count - before[k][0],
                 "s": (h.sum - before[k][1]) / 1e3}
             for k, h in hists.items()}
    split["other_s"] = summary["elapsed_s"] - sum(
        v["s"] for v in split.values())

    # ServeLoad's runner on the trained table: B1 at its shape, bitwise.
    table = model.tables[0].store.read().cpu()
    b1 = rows.LAUNCHES["gather_rows"]
    qrng = np.random.default_rng(seed + 8)
    for _ in range(DLRM_SERVE_CHECKS):
        keys = zipf_ids(qrng, 1.2, 8 * 16, cfg.vocab).reshape(8, 16)
        got = load.runner.run(keys, np.full(8, 16, dtype=np.int64))
        want = rows.gather_rows_plain(table, torch.as_tensor(keys.ravel()))
        assert np.array_equal(got, want.numpy().reshape(got.shape)), \
            "a live DLRM lookup differs from the plain gather"
    assert rows.LAUNCHES["gather_rows"] - b1 == DLRM_SERVE_CHECKS
    rows.LAUNCHES["gather_rows"] = b1
    held = [stream.batch(DLRM_BATCH) for _ in range(4)]
    labels = np.concatenate([b.labels for b in held])
    quant = {}
    for dtype in ("f32", "int8"):
        rep = CheckpointReplica(directory, table_dtype=dtype)
        scorer = SnapshotScorer.from_snapshot(cfg, rep.snapshot())
        scores = np.concatenate([scorer.scores(b.ids, b.dense)
                                 for b in held])
        quant[dtype] = {"auc": exact_auc(scores, labels), "step": rep.step}
        rep.close()
    mv.shutdown()
    lanes = {r["lane"]: r["auc"] for r in summary["freshness"]}
    assert serve["errors"] == 0 and serve["requests"] > 0, serve
    assert summary["publishes"] == 1 + DLRM_STEPS // DLRM_PUBLISH
    assert np.isfinite(summary["final_loss"])
    assert lanes["fresh"] >= lanes["frozen"], lanes
    quant["auc_delta"] = abs(quant["f32"]["auc"] - quant["int8"]["auc"])
    out = {"examples_per_sec": summary["examples_per_sec"],
           "publishes": summary["publishes"], "lanes": lanes,
           "train_auc": summary["train_auc"],
           "final_loss": summary["final_loss"], "serve": serve,
           "quant": quant, "elapsed_s": summary["elapsed_s"],
           "split": split}
    lat = serve["batch_latency_ms"]
    log(f"DLRM online: {DLRM_STEPS} steps x {DLRM_BATCH} at "
        f"{summary['examples_per_sec']:.1f} examples/sec, "
        f"{summary['publishes']} publishes; AUC by lane "
        + ", ".join(f"{k} {v:.4f}" for k, v in lanes.items())
        + f"; serve {serve['achieved_qps']:.1f} of {serve['offered_qps']:.0f}"
        f" requests/sec offered, {serve['requests']} answered, "
        f"{serve['cache_hits']} cache hits, batch p50 {lat['p50']:.3f} ms, "
        f"p99 {lat['p99']:.3f} ms; held-out AUC f32 "
        f"{quant['f32']['auc']:.4f}, int8 {quant['int8']['auc']:.4f}; "
        f"{DLRM_SERVE_CHECKS} runner batches of 8 x 16 keys bitwise the "
        f"plain gather")
    log(f"DLRM online split of {summary['elapsed_s']:.3f} s: "
        f"{split['train.step_ms']['count']} steps "
        f"{split['train.step_ms']['s']:.3f} s, "
        f"{split['publish.latency_ms']['count']} publishes "
        f"{split['publish.latency_ms']['s']:.3f} s, the rest (scoring the "
        f"lanes, drawing batches) {split['other_s']:.3f} s")
    return out


def phase9(seed: int, on_path, card: str, async_ckpt: dict,
           npz: dict) -> dict:
    """Phase 9: the lookup serving plane (live, replica, routed), the
    async checkpoint's readings (run in phase 8's session), DLRM and the
    online loop. Returns the readings and each run's launch counts."""
    log(f"phase 9 on {card}")
    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        live, out["launches"]["live"] = on_path(live_lookups, seed)
        out["replica"], out["launches"]["replica"] = on_path(
            replica_lookups, live, seed, tmp)
    out["live"] = live
    out["async_checkpoint"] = dict(async_ckpt, npz_save_s=npz["save_s"],
                                   npz_mb=npz["mb"])
    log(f"async checkpoint against npz: staged "
        + " / ".join(f"{s['staged_s']:.3f}" for s in async_ckpt["saves"])
        + " s, whole write "
        + " / ".join(f"{s['total_s']:.3f}" for s in async_ckpt["saves"])
        + f" s; npz save_all {npz['save_s']:.3f} s ({npz['mb']:.1f} MB)")
    out["dlrm_parity"], out["launches"]["dlrm_parity"] = on_path(
        dlrm_parity, seed)
    with tempfile.TemporaryDirectory() as tmp:
        out["dlrm"], out["launches"]["dlrm"] = on_path(dlrm_online, seed,
                                                       tmp)
    return out


# ---------------------------------------------------------------------------
# phase 10: the parameter server across processes
# ---------------------------------------------------------------------------
# bench.py's row plane (1,000,000 x 50, 10 Adds of 100,000 ids) on two
# ps_shard_main seats: table PS_TABLE_ID is use_pallas sgd (B2), the next
# one default without the row kernels (B4); reads take B1.
PS_TABLE_ID, PS_ADDS, PS_SEATS = 900, 10, 2
# Each seat's tables, in -ps_tables order: name -> (updater, use_pallas).
PS_TABLES = {"sgd_pallas": ("sgd", True), "default": ("default", False)}
# Distributed word2vec at bench.py's config (V, D, window 5, negative 5,
# AdaGrad, chunk 8192; blocks of 100,000 words): the CLI's two ranks on
# W2V_DIST_WORDS corpus words, and one rank in-process on one block.
W2V_DIST_WORDS, W2V_ONE_RANK_WORDS, W2V_BLOCK = 200_000, 50_000, 100_000
# One rank's tables on the card against the same run on the CPU, per
# table, max |card - cpu| <= W2V_CARD_RTOL * max |cpu|: the row adds are
# bitwise (B4 in lane order, as the CPU's index_add_), but the card's and
# the CPU's sigmoid, log and square root differ in their last bits, and
# each pushed delta carries such a difference into every later pull.
W2V_CARD_RTOL = 1e-4
# The two ranks' embeddings() (the JAX test's tolerance).
W2V_RANKS_RTOL, W2V_RANKS_ATOL = 1e-5, 1e-6
# AsyncTableEngine: threads staging Adds of N_IDS ids each; a drain every
# ENGINE_FLUSH staged Adds.
ENGINE_THREADS, ENGINE_ADDS, ENGINE_FLUSH, ENGINE_STATEFUL_ADDS = 4, 5, 4, 2
# The ASGD convnet through PyTreeParamManager.
CNN_WORKERS, CNN_EPOCHS = 2, 3


def free_ports(n: int) -> list:
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def ps_seat_fleet(tmp: str, rows: int, cols: int, seat_args=(),
                  **kw):
    """``PS_SEATS`` ``ps_shard_main`` seats of ``PS_TABLES`` (matrix
    tables of ``rows`` x ``cols``) as a port ``PSShardFleet`` with no
    client seat: ranks 0..PS_SEATS-1, each binding an ephemeral port and
    announcing it in its addr file, each run's output in ``tmp``. Clients
    connect to the announced addresses (``fleet.addresses()``)."""
    from multiverso_tpu_torch.fleet.ps_fleet import PSShardFleet
    kw.setdefault("supervise", False)
    kw.setdefault("checkpoint_every_s", 0.0)
    return PSShardFleet(
        PS_SEATS, table_id=PS_TABLE_ID, table_size=rows,
        table_kind="matrix", table_cols=cols,
        tables=[u + (":pallas" if k else "")
                for u, k in PS_TABLES.values()],
        workdir=tmp, log_dir=tmp, client_seat=False,
        serve_duration=3600.0,
        extra_seat_args={r: list(seat_args) for r in range(PS_SEATS)},
        **kw)


def seat_launches(fleet) -> dict:
    """Each run's launch counts, keyed "seat R run J" (a SIGKILL'd run
    prints none)."""
    return {f"seat {r} run {run}": fleet.seat_line(r, "PS_SHARD_LAUNCHES",
                                                   run)
            for r in fleet.ranks for run in range(fleet.seat_runs(r))
            if fleet.seat_line(r, "PS_SHARD_LAUNCHES", run) is not None}


def stop_seat_fleet(fleet) -> None:
    """SIGTERM every seat: each closes its service, prints its launch
    counts and must exit 0."""
    for rank, rc in fleet.stop_seats().items():
        assert rc == 0, (rank, rc, fleet.seat_log(rank)[-3000:])


def ps_replay_store(updater: str, use_pallas: bool, rows: int, cols: int,
                    device):
    import numpy as np
    from multiverso_tpu_torch.core.table import ServerStore
    from multiverso_tpu_torch.core.updater import get_updater
    return ServerStore("replay", (rows, cols), np.float32,
                       get_updater(np.float32, updater), device, PS_SEATS,
                       use_pallas_rows=use_pallas)


class SeatPlane:
    """The C client's view of a ``ps_seat_fleet``: ``PS_TABLES`` of
    ``rows`` x ``cols`` split over ``PS_SEATS`` seats by
    ``reference_server_offsets``, and the same Adds replayed through the
    port's store on the CPU (``replay``), shard by shard."""

    def __init__(self, fleet, rows: int, cols: int, n_ids: int, cpu):
        from multiverso_tpu_torch.parallel.ps_service import \
            reference_server_offsets
        from multiverso_tpu_torch.runtime import ffi

        ffi.load()
        self.fleet, self.rows, self.cols, self.n_ids = fleet, rows, cols, \
            n_ids
        self.offs = reference_server_offsets(rows, PS_SEATS)
        self.replay = {name: [ps_replay_store(u, k, self.offs[s + 1]
                                              - self.offs[s], cols, cpu)
                              for s in range(PS_SEATS)]
                       for name, (u, k) in PS_TABLES.items()}
        self.addresses = []

    def connect(self):
        """A C client over the seats' announced addresses (only the
        announcements name their ports) and its tables by name."""
        from multiverso_tpu_torch.runtime import ffi
        peers = self.fleet.addresses()
        assert all(p is not None for p in peers), peers
        self.addresses.append(peers)
        cli = ffi.CClient(peers)
        return cli, {name: cli.matrix_table(PS_TABLE_ID + i, self.rows,
                                            self.cols)
                     for i, name in enumerate(PS_TABLES)}

    def draw(self, rng, n_adds: int) -> list:
        """``n_adds`` Adds of ``n_ids`` ids (duplicates among them)."""
        import numpy as np
        return [(rng.integers(0, self.rows, size=self.n_ids)
                 .astype(np.int32),
                 rng.normal(size=(self.n_ids, self.cols)).astype(np.float32))
                for _ in range(n_adds)]

    def push(self, tables: dict, adds: list) -> float:
        """Each Add into every table over the wire, then into the CPU
        replay; returns the seconds of the pushes."""
        from multiverso_tpu_torch.core.options import AddOption
        t0 = time.perf_counter()
        for ids, d in adds:
            for t in tables.values():
                t.add_rows(ids, d)
        add_s = time.perf_counter() - t0
        opt = AddOption()
        for ids, d in adds:
            for name in tables:
                for s in range(PS_SEATS):
                    lo, hi = self.offs[s], self.offs[s + 1]
                    keep = (ids >= lo) & (ids < hi)
                    self.replay[name][s].apply_rows(ids[keep] - lo, d[keep],
                                                    opt)
        return add_s

    def want(self) -> dict:
        import numpy as np
        return {name: np.concatenate([st.read().numpy() for st in sts])
                for name, sts in self.replay.items()}

    def read_shard(self, table, s: int):
        import numpy as np
        lo, hi = self.offs[s], self.offs[s + 1]
        return np.concatenate([
            table.get_rows(np.arange(a, min(a + self.n_ids, hi),
                                     dtype=np.int32))
            for a in range(lo, hi, self.n_ids)])

    def check_shards(self, tables: dict, want: dict) -> dict:
        """Every shard read back whole, bitwise ``want``; returns the
        shards by (table, seat)."""
        got = {}
        for name, t in tables.items():
            for s in range(PS_SEATS):
                got[name, s] = self.read_shard(t, s)
                assert got[name, s].tobytes() == want[name][
                    self.offs[s]:self.offs[s + 1]].tobytes(), (name, s)
        return got


def ps_row_plane(seed: int, rows: int = ROWS, cols: int = COLS,
                 n_ids: int = N_IDS, n_adds: int = PS_ADDS,
                 seat_args=(), cpu=None) -> dict:
    """Phase 10 (a), (b), (e): two seats, the C client as the worker;
    every shard read back bitwise the CPU replay; then seat 1 killed with
    SIGKILL, respawned at a fresh port, and its shard bitwise the bytes
    before the kill."""
    import numpy as np
    import torch

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        fleet = ps_seat_fleet(tmp, rows, cols, seat_args)
        try:
            t0 = time.perf_counter()
            fleet.start(bringup_timeout_s=300.0)
            out["seat_start_s"] = time.perf_counter() - t0
            plane = SeatPlane(fleet, rows, cols, n_ids,
                              cpu or torch.device("cpu"))
            cli, tables = plane.connect()
            adds = plane.draw(np.random.default_rng(seed + 10), n_adds)
            out["duplicate_ids"] = [int(n_ids - len(np.unique(i)))
                                    for i, _ in adds]
            add_s = plane.push(tables, adds)
            t0 = time.perf_counter()
            got = {name: [t.get_rows(ids) for ids, _ in adds]
                   for name, t in tables.items()}
            get_s = time.perf_counter() - t0
            want = plane.want()
            for name in tables:
                for (ids, _), g in zip(adds, got[name]):
                    assert g.tobytes() == want[name][ids].tobytes(), name
            before = plane.check_shards(tables, want)
            cli.close()
            out.update(
                rows_added=2 * n_adds * n_ids, add_s=add_s,
                add_rows_per_s=2 * n_adds * n_ids / add_s, get_s=get_s,
                get_rows_per_s=2 * n_adds * n_ids / get_s, bitwise=True)
            log(f"PS row plane over the wire (2 seats, C client): "
                f"{2 * n_adds} Adds of {n_ids:,} ids in {add_s:.3f} s "
                f"({out['add_rows_per_s']:,.0f} rows/s), Gets of the same "
                f"ids in {get_s:.3f} s ({out['get_rows_per_s']:,.0f} "
                f"rows/s); every shard bitwise the CPU replay")

            # (b) recovery: kill -9 seat 1 and respawn it: it binds a
            # fresh port, replays its WAL and announces the new address.
            fleet.kill(1)
            fleet.handle(1).wait(timeout=60)
            fleet.spawn_seat(1)
            out["recovery_wall_s"] = fleet.wait_announced(1, 300.0)
            rec = fleet.seat_line(1, "PS_SHARD_RECOVERY")
            assert rec is not None, fleet.seat_log(1)[-3000:]
            cli, tables = plane.connect()
            for name, t in tables.items():
                assert plane.read_shard(t, 1).tobytes() == \
                    before[name, 1].tobytes(), name
            cli.close()
            out["recovery"] = rec
            assert rec["applied"] == 2 * n_adds, rec
            out["addresses"] = plane.addresses
            log(f"seat 1 killed (SIGKILL) and rerun: {rec['applied']} WAL "
                f"records replayed in {rec['seconds']:.3f} s, announced "
                f"{out['recovery_wall_s']:.3f} s after the respawn started "
                f"(process start included) at a fresh port; its shards "
                f"bitwise the bytes before the kill")
        finally:
            stop_seat_fleet(fleet)
        out["seat_launches"] = seat_launches(fleet)
    log("seat launch counts (the killed run prints none): "
        + json.dumps(out["seat_launches"]))
    return out


def w2v_corpus_file(path: str, words: int, seed: int) -> None:
    """A synthetic Zipf corpus over V words in sentences of 500, with every
    word present (so the CLI's dictionary has all V)."""
    import numpy as np
    from multiverso_tpu_torch.models.word2vec import Dictionary
    _, zipf = Dictionary.synthetic_zipf(V, words)
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.choice(V, size=words - V, p=zipf),
                          rng.permutation(V)])
    with open(path, "w") as f:
        for lo in range(0, len(ids), 500):
            f.write(" ".join(f"w{i}" for i in ids[lo:lo + 500]) + "\n")


def w2v_two_ranks(seed: int, words: int = W2V_DIST_WORDS,
                  extra=()) -> dict:
    """Phase 10 (c): ``word2vec_main -world_size=2``, ranks on the card by
    default; both ranks' embeddings() within the JAX test's tolerance."""
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        w2v_corpus_file(corpus, words, seed)
        summary = os.path.join(tmp, "summary")
        cmd = [sys.executable, "-m", "multiverso_tpu_torch.apps.word2vec_main",
               f"-train_file={corpus}",
               f"-output_file={os.path.join(tmp, 'vectors.txt')}",
               f"-size={D}", "-window=5", f"-negative={NEG}", "-min_count=1",
               "-sample=1e-3", "-w2v_optimizer=adagrad",
               f"-batch_size={CHUNK}", f"-data_block_size={W2V_BLOCK}",
               "-world_size=2", f"-rendezvous_dir={tmp}",
               f"-w2v_summary_dir={summary}", *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=900)
        wall = time.perf_counter() - t0
        assert proc.returncode == 0, (proc.stdout[-3000:],
                                      proc.stderr[-3000:])
        ranks = []
        for r in range(2):
            with open(os.path.join(summary, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
            ranks[-1]["emb"] = np.load(os.path.join(summary, f"rank{r}.npy"))
    e0, e1 = ranks[0].pop("emb"), ranks[1].pop("emb")
    assert e0.shape == (V, D), e0.shape
    assert np.isfinite(e0).all() and np.isfinite(e1).all()
    np.testing.assert_allclose(e1, e0, rtol=W2V_RANKS_RTOL,
                               atol=W2V_RANKS_ATOL)
    for r in ranks:
        assert np.isfinite(r["last_loss"]) and r["last_loss"] > 0, r
    log("word2vec_main -world_size=2 (" + ", ".join(
        f"rank {r['rank']} on {r['device']}: {r['words']:,} words, "
        f"{r['words_per_sec']:,.0f} words/sec, last block loss "
        f"{r['last_loss']:.4f}" for r in ranks)
        + f"); {wall:.1f} s with start-up; the two ranks' embeddings() "
        f"max |diff| {float(np.abs(e1 - e0).max()):.3g}")
    return {"ranks": ranks, "wall_s": wall,
            "ranks_max_abs_diff": float(np.abs(e1 - e0).max())}


def w2v_one_rank(seed: int, platform: list, words: int = W2V_ONE_RANK_WORDS
                 ) -> dict:
    """One rank of ``DistributedWord2Vec`` against two in-process seats
    (``platform`` the ``mv.init`` flags); returns its pulled tables."""
    import numpy as np
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models.word2vec.distributed import \
        DistributedWord2Vec
    from multiverso_tpu_torch.parallel.ps_service import PSService
    d, sents = zipf_corpus(V, words // 500, 500, seed=seed + 3)
    cfg = flagship_config(device_pipeline=False, block_words=W2V_BLOCK,
                          pipeline=False)
    mv.init(platform)
    svcs = [PSService(), PSService()]
    peers = [s.address for s in svcs]
    try:
        w0 = DistributedWord2Vec(cfg, d, svcs[0], peers, rank=0)
        DistributedWord2Vec(cfg, d, svcs[1], peers, rank=1)
        stats = w0.train(sents)
        every = np.arange(V, dtype=np.int32)
        tables = {"w_in": w0.w_in.get_rows(every),
                  "w_out": w0.w_out.get_rows(every),
                  "g_in": w0.g_in.get_rows(every),
                  "g_out": w0.g_out.get_rows(every)}
        stats["last_loss"] = w0.last_loss
    finally:
        for s in svcs:
            s.close()
        mv.shutdown()
    return {"stats": stats, "tables": tables}


def w2v_card_against_cpu(seed: int, on_path, card_platform=()) -> tuple:
    import numpy as np
    from multiverso_tpu_torch.utils.configure import reset_flags
    card, counts = on_path(w2v_one_rank, seed, list(card_platform))
    cpu = w2v_one_rank(seed, ["-platform=cpu"])
    reset_flags()     # the flags outlive mv.shutdown(): drop -platform
    errs = {}
    for name, want in cpu["tables"].items():
        got = card["tables"][name]
        assert np.isfinite(got).all(), name
        errs[name] = float(np.abs(got - want).max()
                           / max(float(np.abs(want).max()), 1e-30))
        assert errs[name] <= W2V_CARD_RTOL, (name, errs)
    st = card["stats"]
    log(f"DistributedWord2Vec, one rank against two in-process seats: card "
        f"{st['words']:,} words at {st['words_per_sec']:,.0f} words/sec "
        f"(CPU {cpu['stats']['words_per_sec']:,.0f}); card against CPU per "
        f"table (of its largest value): " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items())
        + f" (limit {W2V_CARD_RTOL})")
    return {"card": st, "cpu": cpu["stats"], "rel_err": errs}, counts


def engine_phase(seed: int, rows: int = ROWS, cols: int = COLS,
                 n_ids: int = N_IDS, cpu=None) -> dict:
    """Phase 10 (d): ``AsyncTableEngine`` on the 1,000,000 x 50 table, 4
    threads staging, drains through B2 (use_pallas sgd) and B4 (default
    without the row kernels), against a float64 model within the
    recursive-summation bound; then the stateful bypass (adagrad, with and
    without the row kernels) bitwise its CPU replay."""
    import threading
    import numpy as np
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core.options import AddOption
    from multiverso_tpu_torch.core.table import ServerStore
    from multiverso_tpu_torch.core.updater import get_updater
    from multiverso_tpu_torch.parallel.async_engine import (AsyncTableEngine,
                                                            WorkerPool)
    cpu = cpu or torch.device("cpu")
    out = {}
    rng = np.random.default_rng(seed + 20)
    stage = [[(rng.integers(0, rows, size=n_ids).astype(np.int32),
               rng.normal(size=(n_ids, cols)).astype(np.float32))
              for _ in range(ENGINE_ADDS)] for _ in range(ENGINE_THREADS)]
    # float64 model and the bound: each element's staged terms are summed
    # in float32 in some order (buffer, then table): |err| <= n u S with n
    # the element's term count, S the sum of their magnitudes, u = 2^-24.
    model = torch.zeros((rows, cols), dtype=torch.float64)
    mag = torch.zeros((rows, cols), dtype=torch.float64)
    cnt = torch.zeros(rows, dtype=torch.float64)
    for adds in stage:
        for ids, d in adds:
            i, d = torch.as_tensor(ids).long(), torch.as_tensor(d).double()
            model.index_add_(0, i, d)
            mag.index_add_(0, i, d.abs())
            cnt.index_add_(0, i, torch.ones(len(i), dtype=torch.float64))
    model = model.numpy()
    bound = (cnt[:, None] * 2.0 ** -24 * mag).numpy()
    for updater, use_pallas, sign in (("sgd", True, -1.0),
                                      ("default", False, 1.0)):
        table = mv.create_table(mv.MatrixTableOption(
            rows, cols, updater=updater, use_pallas=use_pallas))
        eng = AsyncTableEngine(table, flush_pending=ENGINE_FLUSH,
                               sparse_drain_max=rows)
        t0 = time.perf_counter()
        WorkerPool(ENGINE_THREADS).run(
            lambda w: [eng.add_rows_async(i, d) for i, d in stage[w]])
        eng.flush()
        table.store.block()
        secs = time.perf_counter() - t0
        got = table.store.read().cpu().numpy().astype(np.float64)
        err = np.abs(got - sign * model)
        assert (err <= bound).all(), (updater, float(err.max()))
        key = f"{updater}{'_pallas' if use_pallas else ''}"
        out[key] = {"seconds": secs, "rows_per_s":
                    ENGINE_THREADS * ENGINE_ADDS * n_ids / secs,
                    "max_abs_err": float(err.max()),
                    "max_bound": float(bound.max())}
        log(f"AsyncTableEngine {key}: {ENGINE_THREADS} threads x "
            f"{ENGINE_ADDS} Adds of {n_ids:,} ids staged and drained in "
            f"{secs:.3f} s; max |table - float64 model| {err.max():.3g} "
            f"(every element within its summation bound)")
    # The stateful bypass, in the order the threads applied it.
    opt = AddOption(learning_rate=0.05, rho=0.1)
    for use_pallas in (True, False):
        table = mv.create_table(mv.MatrixTableOption(
            rows, cols, updater="adagrad", use_pallas=use_pallas))
        eng = AsyncTableEngine(table)
        order, lock = [], threading.Lock()

        def bypass(w):
            for ids, d in stage[w][:ENGINE_STATEFUL_ADDS]:
                with lock:
                    eng.add_rows_async(ids, d, opt)
                    order.append((ids, d))
                    assert eng.pending == 0

        WorkerPool(ENGINE_THREADS).run(bypass)
        replay = ServerStore("replay", (rows, cols), np.float32,
                             get_updater(np.float32, "adagrad"), cpu, 1,
                             use_pallas_rows=use_pallas)
        for ids, d in order:
            replay.apply_rows(ids, d, opt)
        want, got = replay.store_state(), table.store.store_state()
        assert set(want) == set(got)
        for k in want:
            assert want[k].tobytes() == got[k].tobytes(), (use_pallas, k)
        log(f"AsyncTableEngine adagrad bypass "
            f"({'use_pallas' if use_pallas else 'no row kernels'}): "
            f"{len(order)} Adds applied as they came, data and state "
            f"bitwise the CPU replay")
    return out


def convnet_asgd(seed: int) -> dict:
    """Phase 10 (e): the ASGD convnet, 2 workers through one
    ``PyTreeParamManager`` table on the card."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.binding.param_manager import PyTreeParamManager
    from multiverso_tpu_torch.models import convnet as cn
    from multiverso_tpu_torch.parallel.async_engine import WorkerPool

    def images(n, s):
        rng = np.random.default_rng(s)
        y = rng.integers(0, 2, size=n)
        phase = rng.integers(0, 4, size=n)
        x = np.zeros((n, 16, 16, 1), np.float32)
        for i in range(n):
            img = np.tile((((np.arange(16) + phase[i]) // 2) % 2)[:, None],
                          (1, 16))
            x[i, :, :, 0] = (img.T if y[i] else img) + rng.normal(
                0, 0.3, size=(16, 16))
        return x, y.astype(np.int64)

    cfg = cn.ConvNetConfig(seed=seed, learning_rate=0.03)
    from multiverso_tpu_torch.core.zoo import Zoo
    dev = Zoo.get().device
    params = cn.init_params(cfg, torch.Generator().manual_seed(seed), dev)
    manager = PyTreeParamManager(params, name="cnn_asgd")
    x, y = images(512, seed + 1)
    workers = [cn.ASGDConvNetWorker(cfg, manager, sync_freq=2)
               for _ in range(CNN_WORKERS)]
    losses = [[] for _ in range(CNN_WORKERS)]

    def run(w):
        xs, ys = x[w::CNN_WORKERS], y[w::CNN_WORKERS]
        batches = [(xs[i:i + 32], ys[i:i + 32])
                   for i in range(0, len(xs), 32)]
        for _ in range(CNN_EPOCHS):
            losses[w] += workers[w].train(batches)

    t0 = time.perf_counter()
    WorkerPool(CNN_WORKERS).run(run)
    secs = time.perf_counter() - t0
    assert all(np.isfinite(l).all() for l in losses), losses
    assert workers[0].device.type == dev.type
    xt, yt = images(256, seed + 2)
    acc = cn.ASGDConvNetWorker(cfg, manager).accuracy(xt, yt)
    log(f"ASGD convnet, {CNN_WORKERS} workers x {CNN_EPOCHS} epochs through "
        f"PyTreeParamManager on {dev}: {secs:.2f} s, loss "
        f"{losses[0][0]:.4f} -> {losses[0][-1]:.4f}, held-out accuracy "
        f"{acc:.3f} (chance 0.5)")
    assert acc > 0.6, acc
    return {"seconds": secs, "accuracy": acc,
            "first_loss": losses[0][0], "last_loss": losses[0][-1]}


def phase10(seed: int, on_path, card: str) -> dict:
    """Phase 10: the parameter server across processes on the card.
    Returns the readings and each run's launch counts (the seats' and the
    CLI ranks' as they printed them)."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.utils.configure import reset_flags
    log(f"phase 10 on {card}")
    t0 = time.perf_counter()
    reset_flags()     # no flag of an earlier phase (-sync) carries over
    out = {"launches": {}, "part_s": {}}

    def part(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        out["part_s"][name] = time.perf_counter() - t
        return res

    out["row_plane"] = part("row plane and recovery", ps_row_plane, seed)
    out["w2v_ranks"] = part("word2vec_main -world_size=2", w2v_two_ranks,
                            seed)
    out["w2v_one_rank"], out["launches"]["w2v_one_rank"] = part(
        "one rank, card and CPU", w2v_card_against_cpu, seed, on_path)
    mv.init([])
    out["engine"], out["launches"]["engine"] = part(
        "AsyncTableEngine", on_path, engine_phase, seed)
    out["convnet"], _ = part("convnet", on_path, convnet_asgd, seed)
    mv.shutdown()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 10: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in out["part_s"].items()) + ")")
    return out


# ---------------------------------------------------------------------------
# phase 11: the collective plane
# ---------------------------------------------------------------------------
# The AUTO probe's byte sizes (all under comm_policy.ALLREDUCE_BYTES_MAX,
# so the probe decides each).
PROBE_BYTES = (1 << 10, 1 << 16, 1 << 22)
# mv.aggregate / all-gather / reduce-scatter operands: a vector of
# AGG_ELEMS float32 and COL_ROWS x COLS row blocks (bench.py's row width).
AGG_ELEMS, COL_ROWS = 1 << 20, 1_000
# logreg's data-parallel allreduce at MNIST's widths: DP_STEPS minibatches
# of the config's 20 samples, each rank stepping on its half; the losses
# within rel DP_LOSS_RTOL of one rank's on whole minibatches, the weights
# within LR_ATOL + LR_RTOL * |w| (phase 8's card-against-CPU bound): the
# two halves' mean gradient sums in another order than the whole batch's.
DP_STEPS, DP_BATCH, DP_LOSS_RTOL = 200, 20, 1e-5
# logreg_main -world_size=2: a libsvm file of LR_CLI_SAMPLES MNIST-width
# samples; rank 0's test accuracy must beat LR_CLI_MIN_ACC (chance 0.1).
LR_CLI_SAMPLES, LR_CLI_MIN_ACC = 4_000, 0.3
# Two DistributedWord2Vec ranks over PSService (bench.py's word2vec config,
# SERVE2_WORDS corpus words, one block a rank), then SERVE2_QUERIES
# routed lookups of 1-64 ids against the two live input shards.
SERVE2_WORDS, SERVE2_QUERIES = 100_000, 64
W2V_TABLE_ATTRS = {"w_in": "input_table", "w_out": "output_table",
                   "g_in": "adagrad_in", "g_out": "adagrad_out"}


def probe_readings(mesh, world: int) -> list:
    """The AUTO probe's two legs at each of ``PROBE_BYTES`` on this
    process's device, and the decision each size gets."""
    from multiverso_tpu_torch.parallel import comm_policy as cp
    out = []
    for nbytes in PROBE_BYTES:
        lat = cp.measured_policy_latency_ms(nbytes, mesh, world=world)
        policy = cp.resolve_comm_policy((nbytes // 4,), "float32",
                                        mesh=mesh, world=world,
                                        table=f"probe_{nbytes}")
        assert policy == (cp.PS if lat[cp.PS] < lat[cp.ALLREDUCE]
                          else cp.ALLREDUCE), (lat, policy)
        out.append({"bytes": nbytes, "ps_ms": lat[cp.PS],
                    "allreduce_ms": lat[cp.ALLREDUCE], "policy": policy})
    log(f"AUTO probe at world {world} on {lat['device']}: " + "; ".join(
        f"{r['bytes']} B ps {r['ps_ms']:.4f} ms, allreduce "
        f"{r['allreduce_ms']:.4f} ms -> {r['policy']}" for r in out))
    return out


def w2v_planes(sents, d) -> dict:
    """Phase 11 (a): one flagship block under the fused, ``hybrid`` and
    ``model_average`` planes from the same seed, after a warm-up block:
    each plane's four tables bitwise the fused plane's, B5 launched once a
    block."""
    import torch
    from multiverso_tpu_torch.models.word2vec import Word2Vec
    from multiverso_tpu_torch.ops import sgns

    Word2Vec(flagship_config(), d).train(sentences=sents)   # warm-up
    out, ref = {}, None
    for plane in ("fused", "hybrid", "model_average"):
        w = Word2Vec(flagship_config(comm_policy=None if plane == "fused"
                                     else plane), d)
        assert w.dispatch_mode == "pallas_grid", w.dispatch_mode
        before = sgns.LAUNCHES["sgns_block"]
        st = w.train(sentences=sents)
        launches = sgns.LAUNCHES["sgns_block"] - before
        assert st["comm_mode"] == plane and st["blocks"] == 1, st
        assert launches == 1, launches
        tables = {k: getattr(w, a).store.read()
                  for k, a in W2V_TABLE_ATTRS.items()}
        if ref is None:
            ref = tables
        for k in tables:
            assert torch.equal(tables[k], ref[k]), (plane, k)
        out[plane] = {"words_per_sec": st["words_per_sec"],
                      "words": st["words"], "sgns_block": launches,
                      "synced_words": st["synced_words"],
                      "wordcount_policy": w.comm_policies.get(
                          "w2v_wordcount", "ps")}
    log("word2vec planes at the flagship's widths, one block each, tables "
        "bitwise the fused plane's: " + "; ".join(
            f"{p} {r['words_per_sec']:,.0f} words/sec (B5 "
            f"{r['sgns_block']}, word count on {r['wordcount_policy']}, "
            f"synced words {r['synced_words']})" for p, r in out.items()))
    return out


def _digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def phase11_rank(rank: int, coordinator: str, out: str, seed: int) -> int:
    """One rank of phase 11 (b), a process of its own on the one card:
    joins the world of two over gloo with -coordinator, then runs
    ``mv.aggregate``, the all-gather and reduce-scatter, the AUTO probe at
    world 2, word2vec ``model_average`` (one flagship block) and logreg's
    data-parallel allreduce against one rank's, in that order on both
    ranks. Writes ``rank<r>.json`` and the arrays the parent checks."""
    t_start = time.perf_counter()
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.models.logreg import LogRegConfig
    from multiverso_tpu_torch.models.logreg.model import AllreduceModel
    from multiverso_tpu_torch.models.word2vec import Word2Vec
    from multiverso_tpu_torch.ops import attention, rows, sgns
    from multiverso_tpu_torch.parallel import collectives as col
    from multiverso_tpu_torch.telemetry import get_registry

    t0 = time.perf_counter()
    mv.init([f"-coordinator={coordinator}", "-world_size=2",
             f"-rank={rank}"])
    zoo = Zoo.get()
    mesh = zoo.mesh
    dev = zoo.device
    assert dev.type == "cuda", dev
    res = {"rank": mv.rank(), "size": mv.size(), "device": str(dev),
           "gloo_socket_ifname": os.environ.get("GLOO_SOCKET_IFNAME"),
           "init_s": time.perf_counter() - t0}
    mv.barrier()
    arrays = {}
    rng = np.random.default_rng(seed + 110 + rank)
    vec = rng.normal(size=AGG_ELEMS).astype(np.float32)
    mat = rng.normal(size=(COL_ROWS, COLS)).astype(np.float32)
    shard = rng.normal(size=(COL_ROWS, COLS)).astype(np.float32)
    whole = rng.normal(size=(2 * COL_ROWS, COLS)).astype(np.float32)
    t0 = time.perf_counter()
    arrays["agg_vec"] = mv.aggregate(vec)
    agg_t = mv.aggregate(torch.as_tensor(mat, device=dev))
    assert agg_t.device == dev
    arrays["agg_mat"] = agg_t.cpu().numpy()
    arrays["allgather"] = col.device_allgather(
        torch.as_tensor(shard, device=dev), mesh).cpu().numpy()
    arrays["reduce_scatter"] = col.device_reduce_scatter(
        torch.as_tensor(whole, device=dev), mesh).cpu().numpy()
    res["collectives_s"] = time.perf_counter() - t0
    res["probe"] = probe_readings(mesh, 2)

    # word2vec model_average: one flagship block on this rank's half of
    # the corpus, then the merge; the tables kept on either side of it.
    d, sents = zipf_corpus(V, 1024, 500, seed=seed + 11)
    w = Word2Vec(flagship_config(comm_policy="model_average"), d)
    merge = w._model_average_epoch
    pre = {}

    def kept_merge():
        for k, a in W2V_TABLE_ATTRS.items():
            pre[k] = getattr(w, a).store.read()
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        merge()
        torch.cuda.synchronize(dev)
        res["w2v_merge_s"] = time.perf_counter() - t

    w._model_average_epoch = kept_merge
    for counts in (rows.LAUNCHES, sgns.LAUNCHES, attention.LAUNCHES):
        for key in counts:
            counts[key] = 0
    st = w.train(sentences=sents[rank::2])
    res["launches"] = {**rows.LAUNCHES, **sgns.LAUNCHES,
                       **attention.LAUNCHES}
    res["w2v"] = {k: st[k] for k in ("words", "pairs", "words_per_sec",
                                     "seconds", "blocks", "comm_mode")}
    res["w2v_post_digest"] = {}
    for k, a in W2V_TABLE_ATTRS.items():
        post = getattr(w, a).store.read()
        res["w2v_post_digest"][k] = _digest(post)
        np.save(os.path.join(out, f"pre{rank}_{k}.npy"),
                pre[k].cpu().numpy())
        if rank == 0:
            np.save(os.path.join(out, f"post_{k}.npy"), post.cpu().numpy())

    # logreg allreduce over the data-parallel axis at MNIST's widths, then
    # one rank's model on the whole minibatches (built on both ranks:
    # creating a table is collective).
    X, y = mnist_like(seed)
    Xb = np.concatenate([X, np.ones((len(X), 1), np.float32)], axis=1)
    cfg = LogRegConfig(objective="softmax", num_feature=MNIST_FEATURES,
                       num_class=MNIST_CLASSES, minibatch_size=DP_BATCH,
                       comm_policy="allreduce")
    dp = AllreduceModel(cfg, dp_mesh=mesh, dp_axis="server")
    half = DP_BATCH // 2
    losses = []
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(DP_STEPS):
        lo = i * DP_BATCH + rank * half
        losses.append(dp.update(Xb[lo:lo + half], y[lo:lo + half]))
    torch.cuda.synchronize(dev)
    dp_s = time.perf_counter() - t0
    single = AllreduceModel(cfg)
    want = [single.update(Xb[i * DP_BATCH:(i + 1) * DP_BATCH],
                          y[i * DP_BATCH:(i + 1) * DP_BATCH])
            for i in range(DP_STEPS)]
    got = np.asarray([float(x) for x in losses])
    want = np.asarray([float(x) for x in want])
    assert np.isfinite(got).all() and got[-1] < got[0], got
    loss_rel = float(np.max(np.abs(got - want) / np.abs(want)))
    assert loss_rel <= DP_LOSS_RTOL, loss_rel
    wd, ws = dp.get_weights(), single.get_weights()
    err = np.abs(wd - ws)
    assert bool((err <= LR_ATOL + LR_RTOL * np.abs(ws)).all()), \
        float(err.max())
    res["logreg_dp"] = {"steps": DP_STEPS, "seconds": dp_s,
                        "samples_per_sec": DP_STEPS * half / dp_s,
                        "loss_first": float(got[0]),
                        "loss_last": float(got[-1]),
                        "loss_max_rel_err": loss_rel,
                        "weights_max_abs_err": float(err.max())}
    counters = get_registry().snapshot(buckets=False)["counters"]
    res["host_copies"] = counters.get("comm.collective.host_copies",
                                      {}).get("value", 0)
    res["host_bytes"] = counters.get("comm.collective.host_bytes",
                                     {}).get("value", 0)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    mv.shutdown()
    res["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def collective_ranks(seed: int) -> dict:
    """Phase 11 (b): two rank processes on the one card, one world over
    gloo (``-coordinator``): ``mv.aggregate`` of a numpy vector and a card
    tensor, the all-gather and reduce-scatter of card tensors, all bitwise
    the numpy sums of both ranks' inputs; the AUTO probe at world 2 (the
    same readings and decisions on both ranks); word2vec
    ``model_average`` at the flagship's widths, one block a rank, each
    merged table bitwise the mean of both ranks' pre-merge tables and
    the same on both ranks (B5 once a rank); logreg's data-parallel
    allreduce within its bounds of one rank's."""
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        coordinator = f"127.0.0.1:{free_ports(1)[0]}"
        cmd = [sys.executable, os.path.abspath(__file__), "--seed",
               str(seed), "--phase11-rank"]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            cmd + [str(r), coordinator, tmp], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, p in enumerate(procs):
            assert p.returncode == 0, (r, outs[r][-4000:])
        res, arrays = [], []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
            arrays.append(dict(np.load(os.path.join(tmp, f"rank{r}.npz"))))
        ins = []
        for r in range(2):
            rng = np.random.default_rng(seed + 110 + r)
            ins.append([rng.normal(size=AGG_ELEMS).astype(np.float32),
                        rng.normal(size=(COL_ROWS, COLS)).astype(np.float32),
                        rng.normal(size=(COL_ROWS, COLS)).astype(np.float32),
                        rng.normal(size=(2 * COL_ROWS, COLS))
                        .astype(np.float32)])
        for r in range(2):
            a = arrays[r]
            assert (res[r]["rank"], res[r]["size"]) == (r, 2), res[r]
            assert np.array_equal(a["agg_vec"], ins[0][0] + ins[1][0])
            assert np.array_equal(a["agg_mat"], ins[0][1] + ins[1][1])
            assert np.array_equal(a["allgather"],
                                  np.concatenate([ins[0][2], ins[1][2]]))
            whole = ins[0][3] + ins[1][3]
            assert np.array_equal(a["reduce_scatter"],
                                  whole[r * COL_ROWS:(r + 1) * COL_ROWS])
            assert res[r]["launches"]["sgns_block"] == 1, res[r]["launches"]
        assert res[0]["probe"] == res[1]["probe"]
        assert res[0]["w2v_post_digest"] == res[1]["w2v_post_digest"]
        for k in W2V_TABLE_ATTRS:
            pre = [np.load(os.path.join(tmp, f"pre{r}_{k}.npy"))
                   for r in range(2)]
            post = np.load(os.path.join(tmp, f"post_{k}.npy"))
            assert np.array_equal(post, (pre[0] + pre[1]) / np.float32(2)), k
            assert not np.array_equal(pre[0], pre[1]), k
    log(f"AUTO probe at world 2 on {res[0]['device']} (both ranks read the "
        "same): "
        + "; ".join(f"{r['bytes']} B ps {r['ps_ms']:.4f} ms, allreduce "
                    f"{r['allreduce_ms']:.4f} ms -> {r['policy']}"
                    for r in res[0]["probe"]))
    log("two ranks on one card over gloo (GLOO_SOCKET_IFNAME="
        f"{res[0]['gloo_socket_ifname']}): mv.init {res[0]['init_s']:.2f} "
        f"/ {res[1]['init_s']:.2f} s; aggregate, all-gather and "
        f"reduce-scatter bitwise ({res[0]['collectives_s']:.3f} s, "
        f"{res[0]['host_copies']} host-staged copies a rank); word2vec "
        "model_average one flagship block a rank, merged tables bitwise "
        "the mean of both ranks': " + ", ".join(
            f"rank {r['rank']} {r['w2v']['words_per_sec']:,.0f} words/sec "
            f"({r['w2v']['words']:,} words in {r['w2v']['seconds']:.3f} s, "
            f"merge {r['w2v_merge_s']:.3f} s)" for r in res)
        + "; logreg data-parallel allreduce at MNIST's widths, "
        f"{DP_STEPS} minibatches: losses within "
        f"{res[0]['logreg_dp']['loss_max_rel_err']:.3g} (rel) and weights "
        f"{res[0]['logreg_dp']['weights_max_abs_err']:.3g} (abs) of one "
        f"rank, {res[0]['logreg_dp']['samples_per_sec']:,.0f} samples/sec "
        f"a rank; {wall:.1f} s with start-up, "
        f"{res[0]['seconds']:.1f} / {res[1]['seconds']:.1f} s of it in "
        "each rank's phase")
    return {"ranks": res, "wall_s": wall}


def logreg_cli_two_ranks(seed: int) -> dict:
    """Phase 11 (c): ``logreg_main -world_size=2`` on the card, two PS
    ranks training softmax at MNIST's widths from a libsvm file; exit 0
    and rank 0's test accuracy above ``LR_CLI_MIN_ACC``."""
    import re
    import numpy as np
    X, y = mnist_like(seed)
    X, y = X[:LR_CLI_SAMPLES], y[:LR_CLI_SAMPLES]
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "mnist_like.svm")
        with open(data, "w") as f:
            for row, lab in zip(X, y):
                nz = np.flatnonzero(row)
                f.write(f"{int(lab)} " + " ".join(
                    f"{i}:{row[i]:.6f}" for i in nz) + "\n")
        conf = os.path.join(tmp, "lr.conf")
        with open(conf, "w") as f:
            f.write(f"objective=softmax\nnum_feature={MNIST_FEATURES}\n"
                    f"num_class={MNIST_CLASSES}\nminibatch_size=20\n"
                    "train_epoch=1\n")
        cmd = [sys.executable, "-m", "multiverso_tpu_torch.apps.logreg_main",
               f"-config_file={conf}", f"-lr_train_file={data}",
               f"-lr_test_file={data}", "-world_size=2",
               f"-rendezvous_dir={tmp}"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    assert proc.returncode == 0, text[-4000:]
    acc = [float(m) for m in re.findall(r"test accuracy: ([0-9.]+)", text)]
    assert len(acc) == 1 and acc[0] > LR_CLI_MIN_ACC, (acc, text[-2000:])
    log(f"logreg_main -world_size=2 on the card: {LR_CLI_SAMPLES} samples "
        f"at MNIST's widths over two PS ranks, rank 0's test accuracy "
        f"{acc[0]:.4f}; {wall:.1f} s with start-up")
    return {"accuracy": acc[0], "wall_s": wall}


def w2v_two_rank_serving(seed: int) -> dict:
    """Phase 11 (c): two ``DistributedWord2Vec`` ranks over ``PSService``
    on the card (threads of this process) train one block each, then each
    rank's live input shard is served by a ``SparseLookupRunner`` behind
    ``ServingService`` and ``RoutedLookupClient`` routes lookups over
    both: every reply bitwise the table's ``get_rows`` (B1 under every
    served gather)."""
    import threading
    import numpy as np
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models.word2vec.distributed import \
        DistributedWord2Vec
    from multiverso_tpu_torch.ops import rows
    from multiverso_tpu_torch.parallel.ps_service import PSService
    from multiverso_tpu_torch.serving import (RoutedLookupClient,
                                              ServingService,
                                              SparseLookupRunner)
    d, sents = zipf_corpus(V, SERVE2_WORDS // 500, 500, seed=seed + 12)
    cfg = flagship_config(device_pipeline=False, block_words=W2V_BLOCK,
                          pipeline=False)
    mv.init([])
    svcs = [PSService(), PSService()]
    peers = [s.address for s in svcs]
    serves, client = [], None
    try:
        ws = [DistributedWord2Vec(cfg, d, svcs[r], peers, rank=r)
              for r in range(2)]
        stats = [None, None]

        def train(r):
            stats[r] = ws[r].train(sents[r::2])

        t0 = time.perf_counter()
        threads = [threading.Thread(target=train, args=(r,))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            assert not t.is_alive(), "training hung"
        train_s = time.perf_counter() - t0
        for w in ws:
            w.w_in.flush(wait=True)
        for w in ws:
            svc = ServingService()
            svc.register_runner(SparseLookupRunner(
                w.w_in.local_store,
                row_offset=int(w.w_in.row_offsets[w.rank])),
                buckets=LOOKUP_BUCKETS, max_batch=LOOKUP_BATCH,
                max_wait_ms=1.0)
            serves.append(svc)
        client = RoutedLookupClient([s.address for s in serves],
                                    offsets=ws[0].w_in.row_offsets)
        rng = np.random.default_rng(seed + 13)
        b1 = rows.LAUNCHES["gather_rows"]
        served = []
        t0 = time.perf_counter()
        for _ in range(SERVE2_QUERIES):
            q = rng.integers(0, V, int(rng.integers(1, 65))).astype(np.int64)
            served.append((q, client.lookup(q, deadline_ms=30_000)))
        serve_s = time.perf_counter() - t0
        b1 = rows.LAUNCHES["gather_rows"] - b1
        for q, got in served:
            want = ws[0].w_in.get_rows(q.astype(np.int32))
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert b1 > 0, b1
    finally:
        if client is not None:
            client.close()
        for s in serves:
            s.close()
        for s in svcs:
            s.close()
        mv.shutdown()
    log(f"two DistributedWord2Vec ranks over PSService on the card: "
        + ", ".join(f"rank {r} {st['words']:,} words at "
                    f"{st['words_per_sec']:,.0f} words/sec"
                    for r, st in enumerate(stats))
        + f" ({train_s:.2f} s); {SERVE2_QUERIES} routed lookups over both "
        f"live shards bitwise get_rows in {serve_s:.3f} s, B1 {b1} "
        "launches under the served gathers")
    return {"train": stats, "train_s": train_s, "serve_s": serve_s,
            "serve_b1": b1}


def phase11(seed: int, on_path, card: str) -> dict:
    """Phase 11: the collective plane. Returns the readings and each
    run's launch counts (the rank processes' as they wrote them)."""
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.utils.configure import reset_flags
    import multiverso_tpu_torch as mv
    log(f"phase 11 on {card}")
    t0 = time.perf_counter()
    reset_flags()
    out = {"launches": {}, "part_s": {}}

    def part(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        out["part_s"][name] = time.perf_counter() - t
        return res

    mv.init([])
    out["probe_world1"] = part("probe, one rank", probe_readings,
                               Zoo.get().mesh, 1)
    d, sents = zipf_corpus(V, 512, 500, seed=seed + 10)
    out["w2v_planes"], out["launches"]["w2v_planes"] = part(
        "word2vec planes", on_path, w2v_planes, sents, d)
    mv.shutdown()
    out["ranks"] = part("two ranks", collective_ranks, seed)
    for r in out["ranks"]["ranks"]:
        out["launches"][f"collective rank {r['rank']}"] = r.pop("launches")
    out["logreg_cli"] = part("logreg_main -world_size=2",
                             logreg_cli_two_ranks, seed)
    out["serving"], out["launches"]["w2v_serving"] = part(
        "two-rank word2vec and serving", on_path, w2v_two_rank_serving,
        seed)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 11: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in out["part_s"].items()) + ")")
    return out


# ---------------------------------------------------------------------------
# phase 12: the long-context LM across ranks (gloo ranks on the one card)
# ---------------------------------------------------------------------------
#: world -> (ranks, -mesh_shape, LMConfig fields over LM's). (b) and (c)
#: are cut to 6 layers (of 12) to keep the whole script inside its time
#: limit: their 4 ranks each draw, hold and train the model, and one
#: rank's reference draws it again.
P12_WORLDS = {
    "a": (2, "data:1,seq:2", dict(seq_parallel=2, data_parallel=1)),
    "b": (4, "data:2,seq:2", dict(seq_parallel=2, data_parallel=2,
                                  layers=6)),
    "c": (4, "stage:2,seq:2", dict(pipeline_stages=2, seq_parallel=2,
                                   pipeline_microbatches=4, layers=6)),
}
P12_TIMEOUT_S = 600
# 3 fit steps across ranks against one rank from the same weights: the
# losses (each taken before its step) and the loss after the last step
# within tests/test_torch_attention_lm.py's rtol 1e-4. The parameters
# within P12_PARAM_ATOL: the worlds read at most 1.88e-4 on an H100
# (runs G6, G8), and 3 Adam steps at lr 1e-3 move some parameters ~3e-3
# (a first step is lr * sign(g)), so a world that skipped its updates
# fails; a skipped or wrong last step alone moves the loss after it.
P12_FIT_RTOL = 1e-4
P12_PARAM_ATOL = 1e-3


def _host_bytes() -> float:
    from multiverso_tpu_torch.telemetry import get_registry
    counters = get_registry().snapshot(buckets=False)["counters"]
    return counters.get("comm.collective.host_bytes", {}).get("value", 0)


def _p12_run(res, what, fn, n_tok, want_b6=None):
    """One main-path run of a phase 12 rank: B6's count set to 0 just
    before and read just after, timed, host-staged bytes counted."""
    from multiverso_tpu_torch.ops import attention
    attention.LAUNCHES["flash_block_attn"] = 0
    staged = _host_bytes()
    val, dt = timed(fn)
    b6 = attention.LAUNCHES["flash_block_attn"]
    if want_b6 is not None:
        assert b6 == want_b6, (what, b6, want_b6)
    res["runs"].append({"run": what, "seconds": dt, "b6_launches": b6,
                        "host_bytes": _host_bytes() - staged,
                        "tokens_per_sec": n_tok / dt})
    return val


def _p12_fit_against(model_params, ref, batches, losses, loss_after,
                     tokens, what) -> dict:
    """Hold a world's 3 fit steps (``losses``, final ``model_params``, flat
    names, and ``loss_after``, its loss of ``tokens`` after them) against
    one rank's ``ref`` model from the same weights."""
    import numpy as np
    want = ref.fit(batches)
    assert np.allclose(losses, want, rtol=P12_FIT_RTOL, atol=0), \
        (what, losses, want)
    want_after = ref.loss(tokens)
    after_rel = abs(loss_after - want_after) / abs(want_after)
    assert after_rel <= P12_FIT_RTOL, (what, loss_after, want_after)
    worst = 0.0
    for name, p in ref.params.items():
        err = float((model_params[name].detach() - p.detach()).abs().max())
        worst = max(worst, err)
        assert err <= P12_PARAM_ATOL, (what, name, err, P12_PARAM_ATOL)
    loss_rel = float(np.max(np.abs(np.asarray(losses) - np.asarray(want))
                            / np.abs(np.asarray(want))))
    return {"one_rank_fit": want, "fit_loss_max_rel_err": loss_rel,
            "one_rank_loss_after": want_after,
            "loss_after_rel_err": after_rel,
            "params_max_abs_err": worst, "params_atol": P12_PARAM_ATOL}


def phase12_rank(world: str, rank: int, coordinator: str, out: str,
                 seed: int) -> int:
    """One rank of phase 12's world (a), (b) or (c), a process of its own
    on the one card: joins the world over gloo with ``-coordinator`` and
    ``-mesh_shape``, drives the LM at GPT-2-small widths over the mesh,
    then leaves the world; rank 0 then runs one rank's LM from the same
    weights on the card and holds the world's readings against it.
    Writes ``rank<r>.json``."""
    t_start = time.perf_counter()
    import math
    import torch
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import interop
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.models.attention_lm import (
        AttentionLM, LMConfig, pipeline_params_to_flat)
    from multiverso_tpu_torch.utils.configure import set_flag

    n, spec, kw = P12_WORLDS[world]
    t0 = time.perf_counter()
    mv.init([f"-coordinator={coordinator}", f"-world_size={n}",
             f"-rank={rank}", f"-mesh_shape={spec}"])
    mesh, dev = Zoo.get().mesh, Zoo.get().device
    assert dev.type == "cuda", dev
    res = {"world": world, "rank": mv.rank(), "size": mv.size(),
           "mesh": mesh.shape, "init_s": time.perf_counter() - t0,
           "runs": []}
    batches = cyclic_batches(LM_STEPS + 1, LM_BATCH, LM["seq"], LM_CYCLE,
                             seed=seed + 12)
    tokens, train = batches[0], batches[1:]
    n_tok = LM_BATCH * LM["seq"]
    widths = dict(LM, layers=kw.get("layers", LM["layers"]))
    cfg = LMConfig(**dict(LM, **kw), seed=seed)
    model, build_s = timed(lambda: AttentionLM(cfg, mesh=mesh))
    res["build_s"] = build_s
    res["shard"] = [model.shard.data_index, model.shard.seq_index,
                    getattr(model, "stage", 0)]
    init = None
    if world == "c" and rank == 0:
        # The weights the one-rank reference starts from, flattened.
        init = {k: v.detach().clone() for k, v in pipeline_params_to_flat(
            cfg, model.params).items()}
    set_flag("flash_attention", False)
    if world == "a":
        layers = LM["layers"]
        for mode, b6_on in (("ring", 2 * layers), ("ulysses", layers)):
            cfg.sp_mode = mode
            for flash in (False, True):
                set_flag("flash_attention", flash)
                want = b6_on if flash else 0
                _p12_run(res, f"loss {mode} flash={flash} (warm-up)",
                         lambda: model.loss(tokens), n_tok, want)
                res[f"loss_{mode}_{int(flash)}"] = _p12_run(
                    res, f"loss {mode} flash={flash}",
                    lambda: model.loss(tokens), n_tok, want)
        cfg.sp_mode = "ring"
        set_flag("flash_attention", False)
    res["fit"] = _p12_run(res, f"fit {LM_STEPS} steps",
                          lambda: model.fit(train), LM_STEPS * n_tok, 0)
    assert all(math.isfinite(x) for x in res["fit"]), res["fit"]
    res["loss_after"] = _p12_run(res, "loss after fit",
                                 lambda: model.loss(tokens), n_tok, 0)
    moe = None
    if world == "a":
        mcfg = LMConfig(**dict(LM, layers=MOE_LAYERS), **kw,
                        moe_experts=MOE_EXPERTS, seed=seed)
        moe = AttentionLM(mcfg, mesh=mesh)
        res["moe_loss"] = _p12_run(res, "MoE loss ring flash=False",
                                   lambda: moe.loss(tokens), n_tok, 0)
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    # Every rank's parameters after the same steps: one digest.
    res["digest"] = _digest(torch.cat([p.detach().reshape(-1)
                                       for p in model.parameters()]))
    mv.shutdown()
    if rank == 0:
        # One rank's LM on the card from the same weights.
        ref = AttentionLM(LMConfig(**widths, seed=seed), dev)
        if init is not None:
            interop.load_attention_lm_params(
                ref, {k: v.cpu().numpy() for k, v in init.items()})
        if world == "a":
            for mode in ("ring", "ulysses"):
                ref.cfg.sp_mode = mode
                want = ref.loss(tokens)
                res[f"one_rank_loss_{mode}"] = want
                for flash in (0, 1):
                    got = res[f"loss_{mode}_{flash}"]
                    assert abs(got - want) <= LM_LOSS_RTOL * abs(want), \
                        (mode, flash, got, want)
            ref.cfg.sp_mode = "ring"
            mref = AttentionLM(LMConfig(**dict(LM, layers=MOE_LAYERS),
                                        moe_experts=MOE_EXPERTS, seed=seed),
                               dev)
            want = mref.loss(tokens)
            res["one_rank_moe_loss"] = want
            assert abs(res["moe_loss"] - want) <= LM_LOSS_RTOL * abs(want), \
                (res["moe_loss"], want)
            del mref
        params = (pipeline_params_to_flat(cfg, model.params) if world == "c"
                  else model.params)
        res.update(_p12_fit_against(params, ref, train, res["fit"],
                                    res["loss_after"], tokens,
                                    f"world {world}"))
        del ref
    del model, moe
    res["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def p12_world(world: str, seed: int, card: str) -> dict:
    """Phase 12's world ``world``: its rank processes on the card, their
    readings checked and logged."""
    n, spec, kw = P12_WORLDS[world]
    with tempfile.TemporaryDirectory() as tmp:
        coordinator = f"127.0.0.1:{free_ports(1)[0]}"
        cmd = [sys.executable, os.path.abspath(__file__), "--seed",
               str(seed), "--phase12-rank", world]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            cmd + [str(r), coordinator, tmp], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=P12_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, p in enumerate(procs):
            assert p.returncode == 0, (world, r, outs[r][-4000:])
        res = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
    p12_check_and_log(world, res, wall, card)
    return {"ranks": res, "wall_s": wall}


def p12_check_and_log(world: str, res: list, wall: float, card: str) -> None:
    """A phase 12 world's ranks agree (the same losses and parameters);
    their readings logged."""
    n, spec, _ = P12_WORLDS[world]
    ref = res[0]
    for i, r in enumerate(res):
        assert (r["rank"], r["size"]) == (i, n), r
        assert r["fit"] == ref["fit"], (world, r["fit"], ref["fit"])
        assert r["digest"] == ref["digest"], (world, i)
    by_run = {run["run"]: run for run in ref["runs"]}
    fit = by_run[f"fit {LM_STEPS} steps"]
    log(f"phase 12 ({world}) {spec}, {n} ranks on one card: "
        + (f"loss() ring {ref['loss_ring_0']} (B6 off) / {ref['loss_ring_1']} "
           f"(on, {by_run['loss ring flash=True']['b6_launches']} B6 "
           f"launches a rank), Ulysses {ref['loss_ulysses_0']} / "
           f"{ref['loss_ulysses_1']} ({by_run['loss ulysses flash=True']['b6_launches']}"
           f" B6), one rank {ref['one_rank_loss_ring']}; ring "
           f"{by_run['loss ring flash=False']['tokens_per_sec']:.6g} / "
           f"{by_run['loss ring flash=True']['tokens_per_sec']:.6g}, Ulysses "
           f"{by_run['loss ulysses flash=False']['tokens_per_sec']:.6g} / "
           f"{by_run['loss ulysses flash=True']['tokens_per_sec']:.6g} "
           f"tokens/sec (the world's), ring host-staged "
           f"{by_run['loss ring flash=False']['host_bytes'] / 1e6:.1f} MB a "
           f"rank a loss(); MoE loss {ref['moe_loss']} against one rank's "
           f"{ref['one_rank_moe_loss']}; " if world == "a" else "")
        + f"fit {LM_STEPS} steps {ref['fit']} against one rank's "
        f"{ref['one_rank_fit']} (max rel {ref['fit_loss_max_rel_err']:.3g}; "
        f"loss after {ref['loss_after']} against {ref['one_rank_loss_after']}"
        f", rel {ref['loss_after_rel_err']:.3g}; parameters within {ref['params_max_abs_err']:.3g}, limit "
        f"{ref['params_atol']:.3g}), {fit['tokens_per_sec']:.6g} tokens/sec "
        f"(the world's; {fit['tokens_per_sec'] / n:.6g} a rank), host-staged "
        f"{fit['host_bytes'] / LM_STEPS / 1e6:.1f} MB a step a rank; peak "
        f"{max(r['peak_gib'] for r in res):.2f} GiB a rank; {wall:.1f} s "
        f"with start-up (" + ", ".join(f"{r['seconds']:.1f}" for r in res)
        + f" s in the ranks) [{card}]")


def phase12(seed: int, card: str) -> dict:
    """Phase 12: the long-context LM across ranks: (a) ``seq:2``, (b)
    ``data:2,seq:2``, (c) ``stage:2,seq:2`` (see the module's
    docstring). Returns each world's readings and B6's launches, summed
    over the ranks' main-path runs."""
    import gc
    import torch
    log(f"phase 12 on {card}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"part_s": {}}
    for world in P12_WORLDS:
        t = time.perf_counter()
        out[world] = p12_world(world, seed, card)
        out["part_s"][world] = time.perf_counter() - t
    out["b6_launches"] = sum(run["b6_launches"] for world in P12_WORLDS
                             for r in out[world]["ranks"]
                             for run in r["runs"])
    assert out["b6_launches"] > 0, out
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 12: {out['seconds']:.1f} s (" + ", ".join(
        f"({k}) {v:.1f}" for k, v in out["part_s"].items())
        + f"); B6 launched {out['b6_launches']} times across the ranks")
    return out



# ---------------------------------------------------------------------------
# phase 13: the serving fleet on the card
# ---------------------------------------------------------------------------
# Each lookup replica serves bench.py's row plane (ROWS x COLS float32,
# -fleet_synthetic=ROWSxCOLS@seed); requests carry LOOKUP_KEYS Zipf keys
# (serve_bench's default of 8) from FLEET_THREADS client threads, for
# FLEET_LOAD_S seconds in (a).
FLEET_REPLICAS, FLEET_THREADS, FLEET_LOAD_S = 2, 4, 8.0
# Bring-up, drain and respawn deadline.
FLEET_TIMEOUT_S = 240.0
# (d): ps_fleet seats checkpoint every FLEET_PS_CKPT_S seconds; the C
# client pushes FLEET_PS_ADDS Adds of N_IDS ids before a checkpoint and
# as many after it, and seat 1 is killed before the next one.
FLEET_PS_CKPT_S, FLEET_PS_ADDS = 8.0, 5


def fleet_where(device: str) -> str:
    return "the CPU" if device == "cpu" else "the card"


def fleet_table(rows: int, cols: int, seed: int):
    """The rows of ``-fleet_synthetic=ROWSxCOLS@SEED``, computed on the
    host as every replica computes them before it uploads them."""
    import numpy as np
    return np.random.default_rng(seed).normal(size=(rows, cols)) \
        .astype(np.float32)


class LookupLoad:
    """``threads`` client threads sending Zipf lookups through one
    ``FleetClient`` until stopped, every reply held bitwise against
    ``table``; per-request latencies and every failure kept."""

    def __init__(self, cli, table, seed: int, threads: int = FLEET_THREADS):
        import threading
        import numpy as np
        self.cli, self.table = cli, table
        self.stop_ev = threading.Event()
        self.lat_ms, self.errors, self.n = [], [], 0
        self._lock = threading.Lock()
        self._threads = [threading.Thread(
            target=self._run, args=(np.random.default_rng(seed + i),),
            daemon=True) for i in range(threads)]

    def _run(self, rng) -> None:
        rows = len(self.table)
        while not self.stop_ev.is_set():
            keys = zipf_queries(rng, 64, rows)
            for k in keys:
                if self.stop_ev.is_set():
                    return
                k = k.astype("int32")
                t0 = time.perf_counter()
                try:
                    got = self.cli.lookup(k, deadline_ms=10_000, timeout=30)
                    ok = got.tobytes() == self.table[k].tobytes()
                    err = None if ok else f"rows differ for keys {k}"
                except Exception as e:  # noqa: BLE001 - every failure
                    err = repr(e)       # is reported by the caller
                ms = (time.perf_counter() - t0) * 1e3
                with self._lock:
                    self.n += 1
                    if err is None:
                        self.lat_ms.append(ms)
                    else:
                        self.errors.append(err)

    def start(self) -> "LookupLoad":
        self.t0 = time.perf_counter()
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> dict:
        import numpy as np
        self.stop_ev.set()
        for t in self._threads:
            t.join(timeout=60)
        seconds = time.perf_counter() - self.t0
        lat = np.asarray(self.lat_ms)
        return {"requests": self.n, "errors": len(self.errors),
                "first_errors": self.errors[:3], "seconds": seconds,
                "requests_per_s": len(lat) / seconds,
                "p50_ms": float(np.percentile(lat, 50)) if len(lat) else None,
                "p99_ms": float(np.percentile(lat, 99)) if len(lat) else None}


def fleet_members(cli) -> dict:
    """The router's members by id, from a fresh routing table."""
    return {m["id"]: m for m in cli.refresh().members}


def wait_members(cli, want: int, timeout_s: float = FLEET_TIMEOUT_S,
                 proc=None, text=lambda: "") -> dict:
    """Block until ``want`` members serve (none draining)."""
    t0 = time.perf_counter()
    while True:
        members = fleet_members(cli)
        if len([m for m in members.values()
                if not m.get("draining")]) >= want:
            return members
        assert proc is None or proc.poll() is None, text()[-3000:]
        assert time.perf_counter() - t0 < timeout_s, \
            (members, text()[-3000:])
        time.sleep(0.1)


def tagged_lines(text: str, tag: str) -> list:
    """Every ``TAG {json}`` in ``text``, in order, wherever it starts: a
    replica writes each such line in one write, but another process's
    unfinished line may precede it on the same line of the shared log."""
    dec, out = json.JSONDecoder(), []
    i = text.find(tag + " ")
    while i >= 0:
        obj, end = dec.raw_decode(text, i + len(tag) + 1)
        out.append(obj)
        i = text.find(tag + " ", end)
    return out


def replica_pids(text: str) -> dict:
    """Member id -> pid of each replica's latest run, from its
    ``FLEET_REPLICA_SERVING`` line (a respawn replaces its slot's)."""
    return {o["member"]: o["pid"]
            for o in tagged_lines(text, "FLEET_REPLICA_SERVING")}


def replica_launches(text: str) -> list:
    """Each replica run's ``FLEET_REPLICA_LAUNCHES`` (a SIGKILL'd run
    prints none)."""
    return tagged_lines(text, "FLEET_REPLICA_LAUNCHES")


def fleet_lookups(seed: int, rows: int = ROWS, cols: int = COLS,
                  device: str = "default",
                  load_s: float = FLEET_LOAD_S) -> dict:
    """Phase 13 (a)-(c) and the replicas' part of (e): ``fleet_main
    -fleet_role=local`` with ``FLEET_REPLICAS`` supervised replicas of
    the seeded table on ``device`` (the card unless "cpu"); (a) Zipf
    lookups through ``FleetClient``, bitwise the host's table, with
    requests/sec and per-request p50/p99; (b) ``fleet_main
    -fleet_role=drain`` under load: zero failed requests and every
    member's ``drains_completed`` advanced; (c) replica-1 SIGKILLed under
    load: zero failed requests, the supervisor respawns it, it rejoins
    the ring at a new address and lookups stay bitwise (the seconds from
    the kill to the rejoin). The fleet is stopped with SIGTERM and every
    replica run that was not killed prints its launch counts."""
    import signal
    from multiverso_tpu_torch.fleet import FleetClient

    table = fleet_table(rows, cols, seed)
    out = {"replicas": FLEET_REPLICAS, "keys_per_request": LOOKUP_KEYS}
    dev = [f"-serve_device={device}"]
    with tempfile.TemporaryDirectory() as tmp:
        addr_file = os.path.join(tmp, "router.addr")
        log_path = os.path.join(tmp, "fleet.log")
        cmd = [sys.executable, "-m", "multiverso_tpu_torch.apps.fleet_main",
               "-fleet_role=local", f"-fleet_replicas={FLEET_REPLICAS}",
               "-fleet_supervise=true", "-fleet_supervisor_cooldown_s=1",
               f"-fleet_synthetic={rows}x{cols}@{seed}",
               f"-fleet_addr_file={addr_file}", "-serve_duration=900",
               *dev]
        with open(log_path, "w") as f:
            proc = subprocess.Popen(cmd, cwd=REPO, stdout=f,
                                    stderr=subprocess.STDOUT)

        def text() -> str:
            with open(log_path) as f:
                return f.read()

        cli = None
        try:
            t0 = time.perf_counter()
            while not os.path.exists(addr_file):
                assert proc.poll() is None, text()[-3000:]
                assert time.perf_counter() - t0 < FLEET_TIMEOUT_S
                time.sleep(0.1)
            host, port = open(addr_file).read().split(":")
            router = (host, int(port))
            cli = FleetClient(router, refresh_s=0.05)
            wait_members(cli, FLEET_REPLICAS, proc=proc, text=text)
            out["bringup_s"] = time.perf_counter() - t0

            # (a) lookups.
            load = LookupLoad(cli, table, seed + 130).start()
            time.sleep(load_s)
            out["lookups"] = r = load.stop()
            assert r["errors"] == 0 and r["requests"] > 0, r
            log(f"fleet lookups ({FLEET_REPLICAS} replicas of {rows:,} x "
                f"{cols} float32 on {fleet_where(device)}, {FLEET_THREADS} "
                f"client threads, {LOOKUP_KEYS} Zipf keys a request): "
                f"{r['requests']:,} requests in {r['seconds']:.2f} s, "
                f"{r['requests_per_s']:,.1f} requests/s, p50 "
                f"{r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, every "
                f"reply bitwise the seeded table")

            # (b) a rolling drain under load.
            before = {mid: int(m.get("drains_completed", 0))
                      for mid, m in fleet_members(cli).items()}
            load = LookupLoad(cli, table, seed + 140).start()
            t1 = time.perf_counter()
            drain = subprocess.run(
                [sys.executable, "-m",
                 "multiverso_tpu_torch.apps.fleet_main",
                 "-fleet_role=drain", f"-fleet_router={host}:{port}",
                 *dev], cwd=REPO, capture_output=True, text=True,
                timeout=FLEET_TIMEOUT_S)
            drain_s = time.perf_counter() - t1
            time.sleep(0.5)
            r = load.stop()
            assert drain.returncode == 0, drain.stdout[-3000:] + \
                drain.stderr[-3000:]
            after = {mid: int(m.get("drains_completed", 0))
                     for mid, m in fleet_members(cli).items()}
            assert all(after[mid] > n for mid, n in before.items()), \
                (before, after)
            assert r["errors"] == 0, r
            out["drain"] = dict(r, drain_s=drain_s, drains_before=before,
                                drains_after=after)
            log(f"rolling drain under load: {drain_s:.2f} s for "
                f"{len(before)} members, {r['requests']:,} requests, 0 "
                f"failed, drains_completed {before} -> {after}")

            # (c) SIGKILL replica-1 under load; the supervisor respawns it.
            victim = "replica-1"
            old = fleet_members(cli)[victim]
            pid = replica_pids(text())[victim]
            load = LookupLoad(cli, table, seed + 150).start()
            time.sleep(1.0)
            t_kill = time.perf_counter()
            os.kill(pid, signal.SIGKILL)
            while True:
                m = fleet_members(cli).get(victim)
                if m is not None and not m.get("draining") and \
                        (m["host"], m["port"]) != (old["host"],
                                                   old["port"]):
                    break
                assert proc.poll() is None, text()[-3000:]
                assert time.perf_counter() - t_kill < FLEET_TIMEOUT_S, \
                    text()[-3000:]
                time.sleep(0.05)
            rejoin_s = time.perf_counter() - t_kill
            time.sleep(2.0)
            r = load.stop()
            assert r["errors"] == 0, r
            assert replica_pids(text())[victim] != pid
            assert "fleet supervisor: respawn" in text(), text()[-3000:]
            out["failover"] = dict(r, kill_to_rejoin_s=rejoin_s)
            log(f"{victim} SIGKILLed under load: {r['requests']:,} "
                f"requests, 0 failed (failover); respawned by the "
                f"supervisor and back in the ring {rejoin_s:.2f} s after "
                f"the kill")
            wait_members(cli, FLEET_REPLICAS, proc=proc, text=text)
            load = LookupLoad(cli, table, seed + 160).start()
            time.sleep(1.0)
            r = load.stop()
            assert r["errors"] == 0 and r["requests"] > 0, r
            out["after_respawn"] = r
        finally:
            if cli is not None:
                cli.close()
            if proc.poll() is None:
                proc.terminate()
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            # A replica the local role could not stop must not outlive it.
            for pid in replica_pids(text()).values():
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
        assert rc == 0, (rc, text()[-3000:])
        runs = replica_launches(text())
    # Each replica run that was not SIGKILLed: both baseline slots after
    # the drain, and the respawned one.
    assert len(runs) == FLEET_REPLICAS, runs
    for run in runs:
        want = "cpu" if device == "cpu" else "cuda"
        assert run["device"].startswith(want), run
        if want == "cuda":
            assert run["launches"]["gather_rows"] > 0, run
    out["replica_launches"] = {f"{r['member']} pid {r['pid']}":
                               r["launches"] for r in runs}
    log("fleet replica launch counts: " + json.dumps(
        {k: v["gather_rows"] for k, v in out["replica_launches"].items()}))
    return out


def ps_fleet_plane(seed: int, rows: int = ROWS, cols: int = COLS,
                   n_ids: int = N_IDS, n_adds: int = FLEET_PS_ADDS,
                   ckpt_s: float = FLEET_PS_CKPT_S, device: str = "default",
                   cpu=None) -> dict:
    """Phase 13 (d) and the seats' part of (e): a supervised
    ``PSShardFleet`` of ``PS_SEATS`` seats of ``PS_TABLES`` on ``device``
    checkpointing every ``ckpt_s`` seconds; the C client pushes
    ``n_adds`` Adds, waits for every seat's checkpoint of every table,
    pushes ``n_adds`` more, and seat 1 is SIGKILLed at once; the
    supervisor respawns it, it restores its checkpoint and replays the
    WAL records after it (``PS_SHARD_RECOVERY``), and every shard of both
    seats reads back bitwise the CPU replay of all the Adds."""
    import numpy as np
    import torch

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        fleet = ps_seat_fleet(
            tmp, rows, cols, [f"-serve_device={device}"], supervise=True,
            checkpoint_every_s=ckpt_s, cooldown_s=0.5, join_grace_s=120.0)
        ckpt = [os.path.join(tmp, "ckpt", name) for r in fleet.ranks
                for name in (f"ps_shard{r}.npz",
                             f"ps_shard{r}_t{PS_TABLE_ID + 1}.npz")]
        try:
            t0 = time.perf_counter()
            fleet.start(bringup_timeout_s=FLEET_TIMEOUT_S)
            out["seat_start_s"] = time.perf_counter() - t0
            plane = SeatPlane(fleet, rows, cols, n_ids,
                              cpu or torch.device("cpu"))
            cli, tables = plane.connect()
            rng = np.random.default_rng(seed + 170)
            out["add_s"] = [plane.push(tables, plane.draw(rng, n_adds))]
            # Every seat checkpoints both tables after these Adds.
            t1 = time.time()
            while not all(os.path.exists(p) and os.path.getmtime(p) > t1
                          for p in ckpt):
                assert time.time() - t1 < 3 * ckpt_s + 60, ckpt
                time.sleep(0.05)
            out["add_s"].append(plane.push(tables,
                                           plane.draw(rng, n_adds)))
            cli.close()
            # Killed well before the next checkpoint: the respawn restores
            # the checkpoint and replays the second Adds from its WAL.
            t_kill = time.perf_counter()
            fleet.kill(1)
            while fleet.seat_runs(1) < 2:
                assert time.perf_counter() - t_kill < FLEET_TIMEOUT_S
                time.sleep(0.05)
            fleet.wait_announced(1, FLEET_TIMEOUT_S)
            out["kill_to_announce_s"] = time.perf_counter() - t_kill
            rec = fleet.seat_line(1, "PS_SHARD_RECOVERY")
            assert rec is not None, fleet.seat_log(1)[-3000:]
            assert "restored shard from" in fleet.seat_log(1), \
                fleet.seat_log(1)[-3000:]
            assert rec["applied"] > 0, rec
            out["recovery"] = rec
            cli, tables = plane.connect()
            plane.check_shards(tables, plane.want())
            cli.close()
            out["status"] = fleet.status()
            assert out["status"]["supervisor"]["respawns"] >= 1, out
            log(f"ps_fleet ({PS_SEATS} seats of {rows:,} x {cols}, "
                f"{len(PS_TABLES)} tables, on {fleet_where(device)}): "
                f"{2 * n_adds} Adds of {n_ids:,} ids a table around a "
                f"checkpoint, then seat 1 SIGKILLed and respawned by the "
                f"supervisor: checkpoint restored and {rec['applied']} WAL "
                f"records replayed in {rec['seconds']:.3f} s, announced "
                f"{out['kill_to_announce_s']:.2f} s after the kill; every "
                f"shard bitwise the CPU replay")
        finally:
            stop_seat_fleet(fleet)
        out["seat_launches"] = seat_launches(fleet)
        out["addresses"] = plane.addresses
    for r in fleet.ranks:
        printed = [k for k in out["seat_launches"]
                   if k.startswith(f"seat {r} ")]
        assert printed, (r, out["seat_launches"])
    if device != "cpu":
        for name, c in out["seat_launches"].items():
            for kernel in ("gather_rows", "scatter_add_sorted_rows",
                           "tiled_scatter_add_sorted_rows"):
                assert c[kernel] > 0, (name, c)
    log("ps_fleet seat launch counts (the killed run prints none): "
        + json.dumps(out["seat_launches"]))
    return out


def phase13(seed: int, card: str) -> dict:
    """Phase 13: the serving fleet on the card. Returns the readings and
    each process's launch counts."""
    log(f"phase 13 on {card}")
    t0 = time.perf_counter()
    out = {"part_s": {}}
    t = time.perf_counter()
    out["lookups"] = fleet_lookups(seed)
    out["part_s"]["lookup fleet"] = time.perf_counter() - t
    r = out["lookups"]["lookups"]
    log(f"phase 13 fleet lookups on {card}: {r['requests_per_s']:,.1f} "
        f"requests/s, p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms; "
        f"kill to rejoin {out['lookups']['failover']['kill_to_rejoin_s']:.2f}"
        f" s")
    t = time.perf_counter()
    out["ps_fleet"] = ps_fleet_plane(seed)
    out["part_s"]["ps_fleet"] = time.perf_counter() - t
    out["launches"] = {
        **{f"replica {k}": v
           for k, v in out["lookups"]["replica_launches"].items()},
        **{f"ps_fleet {k}": v
           for k, v in out["ps_fleet"]["seat_launches"].items()}}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 13: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in out["part_s"].items()) + ")")
    return out


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of phase 8's synthetic data")
    parser.add_argument("--phase11-rank", nargs=3,
                        metavar=("RANK", "COORDINATOR", "OUT_DIR"),
                        help="run one rank of phase 11 (b); phase 11 "
                        "starts two of these itself")
    parser.add_argument("--phase12-rank", nargs=4,
                        metavar=("WORLD", "RANK", "COORDINATOR", "OUT_DIR"),
                        help="run one rank of phase 12's world a, b or c; "
                        "phase 12 starts them itself")
    args = parser.parse_args()
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.phase11_rank:
        rank, coordinator, out = args.phase11_rank
        return phase11_rank(int(rank), coordinator, out, args.seed)
    if args.phase12_rank:
        world, rank, coordinator, out = args.phase12_rank
        return phase12_rank(world, int(rank), coordinator, out, args.seed)
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
    wide = check_wide_kernels(dev)
    for k in kernels:
        if k["name"] in wide:
            k["wide"] = wide[k["name"]]
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
    served = serve_lm(dev, card, {
        (r["kind"], r["bucket"]): r["splits"]
        for name in ("paged_decode_attn", "paged_decode_attn_int8")
        for r in wide[name] if r.get("engine_step")})

    # Phase 8: the sparse matrix table (B1, B2), the device KV table (B4,
    # the fold), checkpoints (the fused route) and LDA (B4), then logreg;
    # each run reads the counts.
    p8 = phase8(args.seed, on_path, card)
    p8_runs = p8.pop("launches")
    assert p8_runs["sparse"]["scatter_add_sorted_rows"] == 2 * SPARSE_ADDS
    assert p8_runs["sparse"]["gather_rows"] > 0, p8_runs["sparse"]
    assert p8_runs["device_kv"]["tiled_scatter_add_sorted_rows"] == \
        2 * KV_ADDS, p8_runs["device_kv"]
    assert p8_runs["device_kv"]["fold_sorted_runs"] == 2 * KV_ADDS
    assert p8_runs["checkpoint_tables"]["fused_stateful_sorted_rows"] == 3
    lda_blocks = LDA_SWEEPS * -(-LDA_TOKENS // LDA_BLOCK)
    assert p8_runs["lda"]["tiled_scatter_add_sorted_rows"] == \
        lda_blocks + 1, p8_runs["lda"]

    # Phase 9: the lookup serving plane (B1 under the live, replica and
    # routed runners), the async checkpoint's readings, DLRM and the
    # online loop (the fold under every embedding push).
    p9 = phase9(args.seed, on_path, card, p8.pop("async_checkpoint"),
                p8["checkpoint"])
    p9_runs = p9.pop("launches")
    for run in ("live", "replica"):
        assert p9_runs[run]["gather_rows"] > 0, (run, p9_runs[run])
    for run in ("dlrm_parity", "dlrm"):
        assert p9_runs[run]["fold_sorted_runs"] > 0, (run, p9_runs[run])
    # The PS pulls and ServeLoad's runner.
    assert p9_runs["dlrm"]["gather_rows"] > 0, p9_runs["dlrm"]

    # Phase 10: the parameter server across processes: two ps_shard_main
    # seats (B1 under every Get, B2 under the use_pallas sgd table's Adds,
    # B4 under the default table's, in the live run and in the WAL replay
    # of the rerun seat), the CLI's two word2vec ranks and one in-process
    # rank (B4 under the plain steps, B1 under the local shard's pulls),
    # AsyncTableEngine's drains (B2, B4) and its stateful bypass (the
    # fused route, the fold), the convnet (no row kernel).
    p10 = phase10(args.seed, on_path, card)
    p10_runs = p10.pop("launches")
    p10_runs.update(p10["row_plane"].pop("seat_launches"))
    for r in p10["w2v_ranks"]["ranks"]:
        p10_runs[f"word2vec rank {r['rank']}"] = r.pop("launches")
    for seat in ("seat 0 run 0", "seat 1 run 1"):
        for kernel in ("gather_rows", "scatter_add_sorted_rows",
                       "tiled_scatter_add_sorted_rows"):
            assert p10_runs[seat][kernel] > 0, (seat, p10_runs[seat])
    # The rerun seat replays its PS_ADDS Adds of each table.
    assert p10_runs["seat 1 run 1"]["scatter_add_sorted_rows"] >= PS_ADDS
    for run in ("word2vec rank 0", "word2vec rank 1", "w2v_one_rank"):
        assert p10_runs[run]["tiled_scatter_add_sorted_rows"] > 0, run
        assert p10_runs[run]["gather_rows"] > 0, run
    for kernel in ("scatter_add_sorted_rows", "tiled_scatter_add_sorted_rows",
                   "fused_stateful_sorted_rows", "fold_sorted_runs"):
        assert p10_runs["engine"][kernel] > 0, (kernel, p10_runs["engine"])

    # Phase 11: the collective plane: the AUTO probe and word2vec's three
    # planes on one rank (B5 once a plane and once to warm up), two rank processes over gloo
    # (aggregate and the collectives, the probe at world 2, word2vec
    # model_average with B5 once a rank, logreg's data-parallel
    # allreduce), logreg_main -world_size=2, and two DistributedWord2Vec
    # ranks served from their live shards (B1 under every served gather,
    # B4 under the plain steps).
    p11 = phase11(args.seed, on_path, card)
    p11_runs = p11.pop("launches")
    assert p11_runs["w2v_planes"]["sgns_block"] == 4, p11_runs
    for r in range(2):
        assert p11_runs[f"collective rank {r}"]["sgns_block"] == 1
    assert p11_runs["w2v_serving"]["gather_rows"] > 0, p11_runs
    assert p11_runs["w2v_serving"]["tiled_scatter_add_sorted_rows"] > 0

    # Phase 12: the long-context LM across ranks on the card: seq:2 (ring
    # and Ulysses loss() with B6 off and on, 3 fit steps, the MoE loss),
    # data:2,seq:2 and stage:2,seq:2 (3 fit steps each), each against one
    # rank from the same weights. The ranks count B6 in their own runs.
    p12 = phase12(args.seed, card)

    # Phase 13: the serving fleet on the card: fleet_main's local role
    # with two supervised replicas of the 1,000,000 x 50 table (B1 under
    # every lookup), a rolling drain and a SIGKILLed replica under load,
    # then a supervised ps_fleet of two seats (B1, B2, B4) with a seat
    # SIGKILLed and respawned through its checkpoint and WAL.
    p13 = phase13(args.seed, card)
    p13_runs = p13.pop("launches")

    b4_runs = {"bench.py leg": leg["tiled_scatter_add_sorted_rows"],
               "plain tables": plain_counts["tiled_scatter_add_sorted_rows"],
               "word2vec plain steps":
                   other_counts["tiled_scatter_add_sorted_rows"],
               "phase 8 device KV":
                   p8_runs["device_kv"]["tiled_scatter_add_sorted_rows"],
               "phase 8 LDA": p8_runs["lda"]["tiled_scatter_add_sorted_rows"],
               "phase 10": sum(c["tiled_scatter_add_sorted_rows"]
                               for c in p10_runs.values()),
               "phase 11": sum(c["tiled_scatter_add_sorted_rows"]
                               for c in p11_runs.values()),
               "phase 13": sum(c["tiled_scatter_add_sorted_rows"]
                               for c in p13_runs.values())}
    launches = {
        "gather_rows": plane["gather_rows"] + p8_runs["sparse"]["gather_rows"]
        + sum(c["gather_rows"] for c in p9_runs.values())
        + sum(c["gather_rows"] for c in p10_runs.values()),
        "scatter_add_sorted_rows": plane["scatter_add_sorted_rows"]
        + p8_runs["sparse"]["scatter_add_sorted_rows"]
        + sum(c["scatter_add_sorted_rows"] for c in p10_runs.values()),
        "fused_stateful_sorted_rows": sum(
            r["launches"]["fused_stateful_sorted_rows"]
            for r in stateful.values())
        + p8_runs["checkpoint_tables"]["fused_stateful_sorted_rows"]
        + sum(c["fused_stateful_sorted_rows"] for c in p10_runs.values()),
        "fold_sorted_runs": plain_counts["fold_sorted_runs"]
        + p8_runs["device_kv"]["fold_sorted_runs"]
        + sum(c["fold_sorted_runs"] for c in p9_runs.values())
        + sum(c["fold_sorted_runs"] for c in p10_runs.values()),
        "tiled_scatter_add_sorted_rows": sum(b4_runs.values()),
        "sgns_block": flag["sgns_block"],
        "sgns_block_bf16": flag_bf16["sgns_block_bf16"],
        "flash_block_attn": lm["b6_launches"] + p12["b6_launches"],
        "paged_decode_attn": served["b7_launches"],
        "paged_decode_attn_int8": served["b7_int8_launches"]}
    for name in launches:
        if name != "tiled_scatter_add_sorted_rows":
            launches[name] += sum(c.get(name, 0) for c in p11_runs.values())
            launches[name] += sum(c.get(name, 0) for c in p13_runs.values())
    for k in kernels:
        k["launches"] = launches[k["name"]]
        assert k["launches"] > 0, k
        k["phase8_launches"] = {run: c[k["name"]] for run, c in p8_runs.items()
                                if c.get(k["name"])}
        k["phase9_launches"] = {run: c[k["name"]] for run, c in p9_runs.items()
                                if c.get(k["name"])}
        k["phase10_launches"] = {run: c[k["name"]]
                                 for run, c in p10_runs.items()
                                 if c.get(k["name"])}
        k["phase11_launches"] = {run: c[k["name"]]
                                 for run, c in p11_runs.items()
                                 if c.get(k["name"])}
        k["phase13_launches"] = {run: c[k["name"]]
                                 for run, c in p13_runs.items()
                                 if c.get(k["name"])}
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
            k["variants"].append({
                "layout": "DLRM's PS pushes (phase 9 (d))", "cols": 16,
                "lanes": DLRM_BATCH,
                "pushes": p9["dlrm_parity"]["fold_checked_pushes"],
                "dtypes": ["float32"], "max_abs_err": 0.0})
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
            k["variants"].append({
                "layout": "ServeLoad's runner on DLRM field 0 (phase 9 (d))",
                "cols": 16, "ids": 8 * 16, "batches": DLRM_SERVE_CHECKS,
                "max_abs_err": 0.0})
            k["phase9"] = p9
        if k["name"] == "sgns_block_bf16":
            k["bf16_table_updates_per_sec"] = bf16_plane["updates_per_sec"]
            k["other_paths_words_per_sec"] = {
                name: st["words_per_sec"] for name, st in other.items()}
        if k["name"] == "flash_block_attn":
            k["launches_by_run"] = {r["run"]: r["launches"]
                                    for r in lm["runs"]}
            # Phase 6's launches by the instance that served them (phase
            # 12's ranks run the same heads of 64).
            k["instance_launches"] = lm["b6_instances"]
            k["phase12_launches"] = {
                f"({w}) rank {r['rank']}: {run['run']}": run["b6_launches"]
                for w in P12_WORLDS for r in p12[w]["ranks"]
                for run in r["runs"] if run["b6_launches"]}
            k["phase12"] = p12
        if k["name"] in ("paged_decode_attn", "paged_decode_attn_int8"):
            # Phase 7's launches by mode, and by the instance that served
            # them (each mode reads one page kind).
            own = ("b7_launches" if k["name"] == "paged_decode_attn"
                   else "b7_int8_launches")
            k["launches_by_mode"] = {name: m[own] for name, m
                                     in served["modes"].items()}
            k["instance_launches"] = {}
            for m in served["modes"].values():
                if m[own]:
                    for inst, n in m["b7_instance_launches"].items():
                        k["instance_launches"][inst] = \
                            k["instance_launches"].get(inst, 0) + n
        if k["name"] == "paged_decode_attn":
            k["serving"] = served
        if k["name"] == "scatter_add_sorted_rows":
            k["phase8"] = p8
            k["phase10"] = p10
            k["phase11"] = p11
            k["phase13"] = p13
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
