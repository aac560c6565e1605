"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into its own shared library under the repository's
``build/`` directory (which ``.gitignore`` lists) at first use, and loaded
with ``ctypes``. Nothing here runs at import time: a host without
``nvcc`` or a card imports the package cleanly and only the first kernel
launch needs the toolkit.

The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and a stale library is never loaded. :func:`build_all`
starts one ``nvcc`` per source, all together, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "multiverso_tpu_torch"
SOURCES = ("rows", "sgns", "stateful_rows", "attention", "paged_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]
# Flags of one source only. The stateful updaters' math must round once
# per op, as torch's eager ops do, so nvcc may not contract a*b + c into a
# fused multiply-add there.
EXTRA_FLAGS = {"stateful_rows": ["--fmad=false"]}


def _flags(name: str) -> List[str]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels "
                       "of multiverso_tpu_torch/csrc); put the CUDA "
                       "toolkit's bin directory on PATH or set CUDA_HOME")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log_path = BUILD_DIR / f"{name}.build.log"
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log = open(log_path, "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, log, tmp, out, log_path


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, log, tmp, out, log_path = started
    rc = proc.wait()
    log.close()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {rc}):\n"
                           + log_path.read_text()[-4000:])
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> List[Path]:
    """Compile every listed source that is not built yet, one ``nvcc``
    per source, all started together. Returns the library paths."""
    names = list(names)
    with _lock:
        started = {n: _start(n) for n in names}
        for n in names:
            _finish(n, started[n])
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``csrc/<name>.cu``."""
    path = BUILD_DIR / f"{name}.build.log"
    return path.read_text() if path.exists() else ""


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s card, for a
    launch. Read anew on every call, never kept: a CUDA graph is captured
    on a side stream, and a handle kept from before the capture would
    launch outside it. ``torch._C._cuda_getCurrentRawStream`` (what
    Triton's launcher calls) builds no Python stream object; a build of
    torch without it takes the public path."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(t.device).cuda_stream
    return raw(t.get_device())


def check_launch(err: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error (0 = launched)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")
