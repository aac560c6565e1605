#!/usr/bin/env python3
"""Build several versions of B6's CUDA source (``csrc/attention.cu``) and
hold them side by side on one card (card only).

    python3 scripts/torch_flash_steps.py v0=old.cu s1=step1.cu ... \\
        [--dims 64,320,512] [--out FILE] [--reps N]

With no version given it takes the checkout's ``csrc/attention.cu``. Each
source is compiled with the port's own ``nvcc`` flags (``-Xptxas -v``;
its registers and spills are printed) by ``scripts/_torch_steps.py``.
Each version then runs, against the plain version
``flash_block_attn_plain`` on the same inputs, at every head width of
``--dims`` (default 64): at the LM's eval shape with heads of that width
(8 x 12 x 1,024 x D, causal), on inputs with NaN in the K and V rows that
no query sees (q 256, k 384 at offsets (0, 0)), causal at the offsets
(0, 0), (384, 128) and (128, 384), fully masked by the mask and by a
bias, with a band bias and in bfloat16; at D = 64 also at the ring-step
shapes of ``chip_smoke.RING_SHAPES`` and at D = 8 and 256. Every error is
printed beside ``chip_smoke.ATTN_TOL`` and nothing is asserted, so a
version that misses a tolerance still gets its time. Times are CUDA
events over back-to-back calls at the LM shape of each width (and the
ring shapes at D = 64), the versions in turns (forward, then backward,
the two readings averaged), with ``scaled_dot_product_attention`` and the
plain version at both ends; then each version and the plain version in a
CUDA graph. One JSON record goes to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_steps as steps  # noqa: E402

REPO = steps.REPO
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the card's timing helpers and tolerances)


def build(versions: dict) -> dict:
    """Compile every source, all at once (``scripts/_torch_steps.py``);
    name -> (library or None, compiler output)."""
    logs = steps.build_variants("attention",
                                [(src, "") for src in versions.values()],
                                strict=False)
    built = {}
    for name, src in versions.items():
        lib = steps.variant_library("attention", src)
        built[name] = (lib if os.path.exists(lib) else None, logs[src, ""])
    return built


def loader(path: str):
    lib = ctypes.CDLL(path)
    c, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.mv_flash_block_attn.argtypes = [
        c, c, c, c, c, c, c, i64, i32, i32, i32, ctypes.c_float, i32, i64,
        i64, i32, c]
    lib.mv_flash_block_attn.restype = ctypes.c_int
    return lib


def call(lib, q, k, v, bias=None, *, scale, causal=False, offsets=(0, 0)):
    """One launch of ``lib``'s kernel, as ``ops/attention.py::_launch``."""
    import torch
    B, H, sq, d = q.shape
    o = torch.empty((B, H, sq, d), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, sq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    err = lib.mv_flash_block_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), B * H, sq, k.shape[2], d, float(scale),
        int(causal), offsets[0], offsets[1], int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return o, m, l


def errors(got, want) -> dict:
    """Largest |o/l - plain| and its tolerance check, the largest relative
    l and m errors, whether each is within ``ATTN_TOL``."""
    import torch
    torch.cuda.synchronize()
    tol = chip_smoke.ATTN_TOL
    (o2, m2, l2), (o1, m1, l1) = got, want
    n2 = o2 / torch.clamp(l2, min=1e-20)
    n1 = o1 / torch.clamp(l1, min=1e-20)
    diff = (n2 - n1).abs()
    rec = {"o_err": float(diff.max()),
           # the largest |difference| over its allowance (<= 1 passes)
           "o_margin": float((diff / (tol["o_atol"]
                                      + tol["o_rtol"] * n1.abs())).max()),
           "l_rel": float(((l2 - l1).abs() / l1.abs()).max()),
           "m_rel": float(((m2 - m1).abs() / m1.abs()).max()),
           "m_bitwise": bool(torch.equal(m2, m1)),
           "finite": all(bool(torch.isfinite(x).all()) for x in got)}
    rec["ok"] = (rec["finite"]
                 and bool((diff <= tol["o_atol"]
                           + tol["o_rtol"] * n1.abs()).all())
                 and rec["l_rel"] <= tol["l_rtol"]
                 and rec["m_rel"] <= tol["m_rtol"])
    return rec


def cases(dev, d):
    """(name, inputs, kwargs[, clean inputs]) of every comparison at head
    width ``d``, from one seed."""
    import torch
    from multiverso_tpu_torch.ops.attention import NEG_INF
    g = torch.Generator(device=dev).manual_seed(8)
    inp = chip_smoke.attn_inputs
    b, h, s = chip_smoke.LM_BATCH, chip_smoke.LM["heads"], chip_smoke.LM["seq"]
    sc = d ** -0.5
    out = [("LM shape causal", inp(g, dev, b, h, s, s, d),
            dict(scale=sc, causal=True))]
    q, k, v = inp(g, dev, 2, 3, 256, 384, d)
    kp, vp = k.clone(), v.clone()
    kp[:, :, 256:] = float("nan")
    vp[:, :, 256:] = float("nan")
    out.append(("poisoned", (q, kp, vp), dict(scale=sc, causal=True),
                (q, k, v)))
    if d == 64:
        for b2, h2, s2, d2 in chip_smoke.RING_SHAPES:
            out.append((f"ring {(b2, h2, s2, d2)}",
                        inp(g, dev, b2, h2, s2, s2, d2),
                        dict(scale=d2 ** -0.5)))
    q, k, v = inp(g, dev, 2, 3, 128, 256, d)
    for offs in ((0, 0), (384, 128), (128, 384)):
        out.append((f"causal offsets {offs}", (q, k, v),
                    dict(scale=sc, causal=True, offsets=offs)))
    q, k, v = inp(g, dev, 2, 3, 128, 128, d)
    out.append(("fully masked (causal)", (q, k, v),
                dict(scale=sc, causal=True, offsets=(0, 128))))
    full = torch.full((128, 128), NEG_INF, device=dev)
    out.append(("fully masked (bias)", (q, k, v, full), dict(scale=sc)))
    q, k, v = inp(g, dev, 2, 3, 256, 384, d)
    band = torch.where(torch.arange(384, device=dev)[None, :]
                       > torch.arange(256, device=dev)[:, None] + 100,
                       NEG_INF, 0.0).to(torch.float32)
    out.append(("bias", (q, k, v, band), dict(scale=sc)))
    out.append(("bfloat16", tuple(t.to(torch.bfloat16) for t in (q, k, v)),
                dict(scale=sc)))
    if d == 64:
        for d2 in (8, 256):
            out.append((f"D={d2} causal", inp(g, dev, 2, 3, 256, 384, d2),
                        dict(scale=d2 ** -0.5, causal=True,
                             offsets=(128, 0))))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="*", metavar="NAME=SOURCE")
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "flash_steps.json"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dims", default="64",
                    help="head widths, comma-separated (default 64)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_steps: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    versions = dict(v.split("=", 1) for v in args.versions) or {
        "current": os.path.join(REPO, "multiverso_tpu_torch", "csrc",
                                "attention.cu")}
    card = chip_smoke.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    built = build({n: os.path.abspath(v) for n, v in versions.items()})
    libs, rec = {}, {"card": card, "versions": {}}
    for name, (path, log) in built.items():
        regs = [f"{kernel}: {line}"
                for kernel, line in chip_smoke.ptxas_lines(log)]
        rec["versions"][name] = {"source": versions[name], "built": bool(path),
                                 "ptxas": regs, "cases": {}, "ms": {}}
        print(f"{name}: {'built' if path else 'FAILED to build'}", flush=True)
        for ln in (regs if path else log.splitlines()[-30:]):
            print(f"  {ln}", flush=True)
        if path:
            libs[name] = loader(path)

    dev = torch.device("cuda", 0)
    for d in (int(x) for x in args.dims.split(",")):
        compare_and_time(d, dev, libs, rec, args.reps)
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(card)
    return 0


def compare_and_time(d: int, dev, libs: dict, rec: dict, reps: int) -> None:
    """Every case at head width ``d`` against the plain version, each
    version's errors into ``rec``; then the LM shape (and at D = 64 the
    ring shapes) timed, the versions in turns between SDPA and the plain
    version."""
    import torch.nn.functional as F
    from multiverso_tpu_torch.ops import attention
    all_cases = cases(dev, d)
    for case in all_cases:
        what, inputs, kw = case[:3]
        what = f"D={d} {what}"
        clean = case[3] if len(case) > 3 else inputs
        q, k, v = clean[:3]
        bias = inputs[3] if len(inputs) > 3 else None
        want = attention.flash_block_attn_plain(q, k, v, bias, **kw)
        for name, lib in libs.items():
            try:
                e = errors(call(lib, *inputs[:3], bias, **kw), want)
            except RuntimeError as exc:
                e = {"ok": False, "error": str(exc)}
            rec["versions"][name]["cases"][what] = e
            print(f"{name} {what}: {e}", flush=True)
        del want

    timed = [c for c in all_cases
             if c[0] == "LM shape causal" or c[0].startswith("ring")]
    names = list(libs)
    for what, inputs, kw in (c[:3] for c in timed):
        what = f"D={d} {what}"
        q, k, v = inputs

        def run_plain():
            attention.flash_block_attn_plain(q, k, v, **kw)

        def run_sdpa():
            F.scaled_dot_product_attention(q, k, v,
                                           is_causal=kw.get("causal", False))

        reads = {n: [] for n in names + ["plain", "sdpa"]}
        for order in (names, names[::-1]):
            reads["sdpa"].append(chip_smoke.cuda_ms(run_sdpa, reps))
            reads["plain"].append(chip_smoke.cuda_ms(run_plain, reps))
            for n in order:
                reads[n].append(chip_smoke.cuda_ms(
                    lambda: call(libs[n], q, k, v, **kw), reps))
        line = []
        for n, r in reads.items():
            ms = sum(r) / len(r)
            if n in libs:
                rec["versions"][n]["ms"][what] = ms
            else:
                rec.setdefault(n + "_ms", {})[what] = ms
            line.append(f"{n} {ms:.4f} ({', '.join(f'{x:.4f}' for x in r)})")
        print(f"ms at {what}: " + "; ".join(line), flush=True)
        # The same calls captured in CUDA graphs (no host cost a call).
        graphs = {"plain": chip_smoke.graph_ms(run_plain, reps=5, calls=5)}
        for n in names:
            graphs[n] = chip_smoke.graph_ms(
                lambda: call(libs[n], q, k, v, **kw), reps=5, calls=5)
            rec["versions"][n].setdefault("graph_ms", {})[what] = graphs[n]
        rec.setdefault("plain_graph_ms", {})[what] = graphs["plain"]
        print(f"graph ms at {what}: " + "; ".join(
            f"{n} {x:.4f}" for n, x in graphs.items()), flush=True)
        del q, k, v


if __name__ == "__main__":
    sys.exit(main())
