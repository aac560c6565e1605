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
   B1 ``gather_rows`` and B2 ``scatter_add_sorted_rows`` (both signs) with
   100,000 ids into a 1,000,000 x 50 table, bitwise; B5 ``sgns_block`` on
   one full flagship block (V=50,000, D=128, C=8192, K=5, masked tail
   chunk), each table within ``SGNS_RTOL[table]`` of its largest value and
   the loss within ``SGNS_LOSS_RTOL``; then every other compiled variant
   of each kernel once at a small shape (row widths 128 and 25, B5 with
   10 negatives and with D=126, and SGD), at the same tolerances;
3. the table plane: ``mv.init()`` on the card, 1,000,000 x 50
   ``use_pallas`` tables (default and sgd updaters), row Adds/Gets at 10%
   coverage checked against a numpy replay (and bitwise against the plain
   version on the CPU), B1 and B2 launched; param updates/sec;
4. the word2vec flagship through ``Word2Vec.train`` at bench width on a
   synthetic Zipf corpus: one warm-up block, then 3 full blocks with the B5
   kernel launched once per block and a finite loss; words/sec, pairs/sec;
5. the CLI (``python -m multiverso_tpu_torch.apps.word2vec_main``) on a
   two-topic corpus: intra-topic cosine must exceed cross-topic cosine;
6. a JSON line of the kernels, the card line, and the result line.

The launch counts are set to 0 just before each main-path phase (3 and 4)
and read just after it, so the comparisons of phase 2 do not count.
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
# B5 tolerance, per table: max |kernel - plain| <= SGNS_RTOL[table] *
# max |plain|. The kernel reduces the dot products with warp shuffles and
# the plain version with torch sums, and the plain version's index_add_ on
# the card adds a row's duplicate lanes with atomics in no fixed order;
# the block's 111 chunks carry those roundings on. The AdaGrad sums only
# grow (sums of squares), so they stay close in relative terms; an
# embedding row is a sum of hundreds of steps of both signs per chunk, so
# its rounding differences are large against its value. One flagship
# block on an H100 measured 9.4e-5 (w_in, largest |value| 0.54), 2.4e-4
# (w_out, 0.83), 1.5e-4 (g_in, 229) and 1.8e-4 (g_out, 405). A wrong
# update of one lane moves a row by about lr = 0.025.
SGNS_RTOL = {"w_in": 2e-3, "w_out": 2e-3, "g_in": 1e-5, "g_out": 1e-5}
SGNS_LOSS_RTOL = 1e-4

V, D, CHUNK, NEG = 50_000, 128, 8192, 5
ROWS, COLS, N_IDS = 1_000_000, 50, 100_000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def bound_ms(n_bytes: float, n_ops: float = 0.0):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zipf_corpus(vocab: int, n_sent: int, sent_len: int, seed: int = 0):
    import numpy as np
    from multiverso_tpu_torch.models.word2vec import Dictionary
    d, zipf = Dictionary.synthetic_zipf(vocab, n_sent * sent_len)
    rng = np.random.default_rng(seed)
    mat = rng.choice(vocab, size=(n_sent, sent_len), p=zipf).astype(np.int32)
    return d, list(mat)


def flagship_config():
    from multiverso_tpu_torch.models.word2vec import Word2VecConfig
    # bench.py's headline configuration (bench.py:106-112).
    return Word2VecConfig(embedding_size=D, window=5, negative=NEG,
                          batch_size=CHUNK, sample=1e-3, sg=True, hs=False,
                          optimizer="adagrad", epochs=1, pipeline=True,
                          device_pipeline=True, block_sentences=512,
                          pad_sentence_length=512, param_dtype="float32",
                          compact_pairs=True, dispatch_mode=None, seed=0)


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
    b1_ms = cuda_ms(lambda: rows.gather_rows(table, ids), 50)
    b1_plain = cuda_ms(lambda: rows.gather_rows_plain(table, ids), 50)
    b1_lib = cuda_ms(lambda: torch.index_select(table, 0, ids64), 50)
    b1_bound = bound_ms(N_IDS * 4 + uniq * COLS * 4 + N_IDS * COLS * 4)
    log(f"B1 gather_rows: max_abs_err {err_b1} (bitwise), kernel "
        f"{b1_ms:.4f} ms, plain {b1_plain:.4f} ms, index_select "
        f"{b1_lib:.4f} ms, bound {b1_bound[0]:.4f} ms ({b1_bound[1]})")

    sorted_ids, order = torch.sort(ids.to(torch.int64), stable=True)
    deltas = torch.randn((N_IDS, COLS), generator=g, device=dev)
    sorted_deltas = deltas.index_select(0, order)
    err_b2 = 0.0
    for sign in (1.0, -1.0):
        a = table.clone()
        b = table.clone()
        rows.scatter_add_sorted_rows(a, sorted_ids, sorted_deltas, sign)
        rows.scatter_add_sorted_rows_plain(b, sorted_ids, sorted_deltas,
                                           sign)
        torch.cuda.synchronize()
        e = float((a - b).abs().max())
        assert torch.equal(a, b), f"scatter_add sign {sign} differs: {e}"
        err_b2 = max(err_b2, e)
    work = table.clone()
    b2_ms = cuda_ms(lambda: rows.scatter_add_sorted_rows(
        work, sorted_ids, sorted_deltas), 50)
    b2_plain = cuda_ms(lambda: rows.scatter_add_sorted_rows_plain(
        work, sorted_ids, sorted_deltas), 10)
    b2_lib = cuda_ms(lambda: work.index_add_(0, sorted_ids, sorted_deltas),
                     50)
    b2_bound = bound_ms(N_IDS * 4 + N_IDS * COLS * 4 + 2 * uniq * COLS * 4,
                        N_IDS * COLS)
    log(f"B2 scatter_add_sorted_rows (signs +1, -1): max_abs_err {err_b2} "
        f"(bitwise), kernel {b2_ms:.4f} ms, plain {b2_plain:.4f} ms, "
        f"index_add_ {b2_lib:.4f} ms, bound {b2_bound[0]:.4f} ms "
        f"({b2_bound[1]})")
    return [
        {"name": "gather_rows", "route": "cuda",
         "source": "multiverso_tpu_torch/csrc/rows.cu",
         "replaces": "multiverso_tpu/ops/pallas_rows.py:106",
         "max_abs_err": err_b1, "ms": b1_ms, "plain_ms": b1_plain,
         "bound_ms": b1_bound[0], "bound_by": b1_bound[1],
         "library_ms": b1_lib},
        {"name": "scatter_add_sorted_rows", "route": "cuda",
         "source": "multiverso_tpu_torch/csrc/rows.cu",
         "replaces": "multiverso_tpu/ops/pallas_rows.py:186",
         "max_abs_err": err_b2, "ms": b2_ms, "plain_ms": b2_plain,
         "bound_ms": b2_bound[0], "bound_by": b2_bound[1],
         "library_ms": b2_lib},
    ]


def flagship_block(dev):
    """One block of the flagship's main path: a Word2Vec at bench width
    builds the block's pair streams exactly as ``train`` does."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.models.word2vec import Word2Vec
    from multiverso_tpu_torch.models.word2vec.model import (pair_gen,
                                                            pair_stream_shape)
    d, sents = zipf_corpus(V, 512, 500, seed=3)
    w2v = Word2Vec(flagship_config(), d)
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
    tables = (w2v.input_table.store.data.clone(),
              0.1 * torch.randn((V, D), generator=g, device=dev),
              torch.zeros((V, D), device=dev),
              torch.zeros((V, D), device=dev))
    return tables, streams, np.float32(cfg.learning_rate)


def sgns_bound(streams, n_live: int):
    """Least time for one block: each live lane's ids once, each touched
    row of the four tables read and written once, and the arithmetic of
    the live pairs (dots, gradients, AdaGrad updates) at float32 rate."""
    import torch
    centers, contexts, negs, n_pairs = streams
    c = centers[:n_live].reshape(-1)[:int(n_pairs)]
    o = contexts[:n_live].reshape(-1)[:int(n_pairs)]
    k = negs[:n_live].reshape(-1, NEG)[:int(n_pairs)]
    u_in = int(torch.unique(c).numel())
    u_out = int(torch.unique(torch.cat([o, k.reshape(-1)])).numel())
    p = int(n_pairs)
    n_bytes = p * (2 + NEG) * 4 + 2 * 2 * (u_in + u_out) * D * 4
    flops_per_pair = (2 * D * (1 + NEG) + D * (2 * NEG + 2) + D * (1 + NEG)
                      + 7 * D * (2 + NEG))
    return bound_ms(n_bytes, p * flops_per_pair)


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
    # The reference's own spread: the plain version again on the same
    # inputs (its index_add_ atomics add duplicates in another order).
    again = [t.clone() for t in tables]
    sgns.sgns_block_plain(*again, *streams[:3], n_pairs, lr, True)
    log("B5 plain vs plain: " + ", ".join(
        f"{name} {float((a - b).abs().max()):.3e}"
        for name, a, b in zip(TABLES, again, plain)))
    launch = sgns.prepare_sgns_block(*[t.clone() for t in tables],
                                     *streams[:3], n_pairs, lr, True)
    ms = cuda_ms(lambda: sgns.launch_sgns_block(launch), 5, warmup=1)
    glue_ms = cuda_ms(lambda: sgns.prepare_sgns_block(
        *launch.tables, *streams[:3], n_pairs, lr, True), 5, warmup=1)
    work = [t.clone() for t in tables]
    plain_ms = cuda_ms(lambda: sgns.sgns_block_plain(
        *work, *streams[:3], n_pairs, lr, True), 2, warmup=1)
    bound = sgns_bound(streams, n_live)
    log(f"B5 sgns_block: kernel {ms:.4f} ms per block ({launch.grid} CTAs "
        f"x 256 threads, cooperative), glue sort {glue_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
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
            "library_ms": None}


def check_variants(dev) -> dict:
    """Every compiled variant the main path does not reach, once at a small
    shape against its plain version: the row kernels at widths 128 (16-byte
    loads) and 25 (4-byte loads; the main path's 50 takes 8-byte loads),
    bitwise; B5 built for 16 negatives (K=10), for widths that are not a
    multiple of 4 (D=126, with K=5 and K=10), and SGD, with skewed ids so
    long runs take the CTA path. Returns {kernel: [variant records]}."""
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
    for d, k, adagrad in ((128, 10, True), (126, 5, True), (126, 10, True),
                          (128, 5, False)):
        streams = (draw(n, c), draw(n, c), draw(n, c, k))
        n_pairs = torch.tensor(3 * c + 517, dtype=torch.int32, device=dev)
        tables = (0.1 * torch.randn((v, d), generator=g, device=dev),
                  0.1 * torch.randn((v, d), generator=g, device=dev),
                  torch.zeros((v, d), device=dev),
                  torch.zeros((v, d), device=dev))
        kern = [t.clone() for t in tables]
        plain = [t.clone() for t in tables]
        lk = float(sgns.sgns_block_cuda(*kern, *streams, n_pairs, 0.025,
                                        adagrad))
        lp = float(sgns.sgns_block_plain(*plain, *streams, n_pairs, 0.025,
                                         adagrad))
        what = f"B5 variant D={d} K={k} {'adagrad' if adagrad else 'sgd'}"
        log(f"{what}: V={v} C={c}, 3 full chunks + a tail of 517; loss "
            f"{lk} vs plain {lp}")
        errs = sgns_table_errs(kern, plain, what)
        assert abs(lk - lp) <= SGNS_LOSS_RTOL * abs(lp), (what, lk, lp)
        out["sgns_block"].append({"d": d, "k": k, "adagrad": adagrad,
                                  "max_abs_err_tables": errs})
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


# ---------------------------------------------------------------------------
# phase 4: the flagship
# ---------------------------------------------------------------------------
def flagship(sents, d) -> dict:
    import math
    from multiverso_tpu_torch.models.word2vec import Word2Vec
    from multiverso_tpu_torch.ops import sgns

    w2v = Word2Vec(flagship_config(), d)
    assert w2v.dispatch_mode == "pallas_grid", w2v.dispatch_mode
    w2v.train(sentences=sents[:512])            # warm-up block
    w2v.trained_words = 0
    sgns.LAUNCHES["sgns_block"] = 0
    stats = w2v.train(sentences=sents[512:512 * 4])
    launches = sgns.LAUNCHES["sgns_block"]
    assert stats["blocks"] == 3, stats
    assert launches == stats["blocks"], (launches, stats["blocks"])
    assert math.isfinite(stats["loss"]), stats
    log(f"flagship word2vec (V={V}, D={D}, window 5, negative {NEG}, chunk "
        f"{CHUNK}, adagrad, pallas_grid): {stats['words']} words, "
        f"{stats['pairs']} pairs in {stats['seconds']:.4f} s -> "
        f"{stats['words_per_sec']:.6g} words/sec, "
        f"{stats['pairs'] / stats['seconds']:.6g} pairs/sec, loss "
        f"{stats['loss']:.4f}, sgns_block launches {launches}")
    return stats


# ---------------------------------------------------------------------------
# phase 5: the CLI
# ---------------------------------------------------------------------------
def cli_topics() -> None:
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
               "-pad_sentence_length=16"]
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
        assert "pallas_grid" in proc.stdout and "cuda" in proc.stdout, tail
        log(f"CLI word2vec_main on the card: intra-topic cosine {intra:.4f}"
            f", cross-topic {inter:.4f}")
        assert intra > inter + 0.1, (intra, inter)


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.ops import _build, rows, sgns

    # Phase 1: build, record the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {list(_build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    # Phase 2: kernels against their plain versions.
    mv.init([])
    kernels = check_row_kernels(dev)
    kernels.append(check_sgns_kernel(dev))
    variants = check_variants(dev)
    for k in kernels:
        k["variants"] = variants[k["name"]]
    mv.shutdown()

    # Phase 3: the table plane (counts read for B1/B2).
    mv.init([])
    rows.LAUNCHES.update(gather_rows=0, scatter_add_sorted_rows=0)
    table_plane()
    plane_launches = dict(rows.LAUNCHES)
    mv.shutdown()
    assert plane_launches["gather_rows"] > 0, plane_launches
    assert plane_launches["scatter_add_sorted_rows"] > 0, plane_launches

    # Phase 4: the flagship (counts read for B5).
    d, sents = zipf_corpus(V, 512 * 4, 500)
    mv.init([])
    flagship(sents, d)
    flag_launches = sgns.LAUNCHES["sgns_block"]
    mv.shutdown()

    # Phase 5: the CLI.
    cli_topics()

    launches = dict(plane_launches, sgns_block=flag_launches)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        assert k["launches"] > 0, k
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
