"""The shared runner of the port's kernel steps scripts (card only):
versions of one kernel side by side, each in a process of its own.

A version is either a tree of the repository (``--tree NAME=DIR``, for
example the parent commit unpacked by ``git archive`` into ``build/``:
its own wrapper and kernel source) or a variant of this checkout's kernel
source with this checkout's C interface (``--cu NAME=FILE``), built with
the port's ``nvcc`` flags for that source plus the version's
``--flags NAME=FLAGS`` (``-DNAME=VALUE`` overrides, space-separated),
with this checkout's ``csrc/`` on the include path (``runs.cuh``), and
run through this checkout's wrapper. With neither, the checkout itself
is the one version. ``--order`` runs them in turns, repeats allowed
(``parent,new,new,parent``). A script passes its own readings as
``child`` (``child_spec`` reads its version); each child prints one JSON
record as its last line, and the
records, with the version's name and the card's name and power limit,
go to ``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shlex
import subprocess
import sys
from typing import Callable, Dict, List, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "multiverso_tpu_torch", "csrc")


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--cu", action="append", default=[], metavar="NAME=FILE")
    ap.add_argument("--flags", action="append", default=[],
                    metavar="NAME=FLAGS")
    ap.add_argument("--order", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", help=argparse.SUPPRESS)


def versions(args) -> Dict[str, Tuple[str, str, str]]:
    """name -> (tree, variant source or "", extra nvcc flags or "")."""
    flags = dict(f.split("=", 1) for f in args.flags)
    out = {}
    for spec in args.tree:
        name, path = spec.split("=", 1)
        out[name] = (os.path.abspath(path), "", "")
    for spec in args.cu:
        name, path = spec.split("=", 1)
        out[name] = (REPO, os.path.abspath(path), flags.get(name, ""))
    return out or {"checkout": (REPO, "", "")}


def child_spec(args) -> Tuple[str, str, str]:
    """(tree, variant source or "", extra flags or "") of a child."""
    return tuple(json.loads(args.child))


def variant_library(source: str, cu: str, flags: str = "") -> str:
    """Where the variant ``cu`` of ``csrc/<source>.cu``, built with the
    extra ``flags``, is built."""
    digest = hashlib.sha256(open(cu, "rb").read())
    digest.update(flags.encode())
    return os.path.join(REPO, "build", f"{source}_steps",
                        f"{os.path.basename(cu)}-{digest.hexdigest()[:12]}"
                        ".so")


def build_variants(source: str, variants: Sequence[Tuple[str, str]],
                   strict: bool = True) -> Dict[Tuple[str, str], str]:
    """Compile every (variant source, extra flags) at once with the
    port's flags for ``csrc/<source>.cu``; {(cu, flags): compiler output}.
    A failed build raises, or with ``strict`` false leaves no library."""
    sys.path.insert(0, REPO)
    from multiverso_tpu_torch.ops import _build
    procs, logs = {}, {}
    for cu, flags in dict.fromkeys(variants):
        lib = variant_library(source, cu, flags)
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        if os.path.exists(lib):
            os.remove(lib)
        procs[cu, flags] = subprocess.Popen(
            [_build._nvcc(), *_build._flags(source), "-I", CSRC,
             *shlex.split(flags), "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        logs[key], _ = proc.communicate()
        if proc.returncode != 0 and strict:
            raise RuntimeError(f"nvcc failed for {key}:\n{logs[key][-3000:]}")
    return logs


def import_from(tree: str, module: str):
    """Import ``multiverso_tpu_torch.<module>`` from ``tree``. This
    checkout's ``chip_smoke`` (inputs, timing helpers, tolerances) is
    imported first, so a tree's own copy never replaces it."""
    import importlib
    sys.path.insert(0, REPO)
    import chip_smoke  # noqa: F401
    sys.path.insert(0, tree)
    mod = importlib.import_module(f"multiverso_tpu_torch.{module}")
    root = os.path.dirname(os.path.dirname(os.path.dirname(mod.__file__)))
    assert root == os.path.abspath(tree), mod.__file__
    return mod


def use_library(wrapper, path: str, names: Sequence[str],
                lib_attr: str = "_lib", keep: Sequence[str] = ()):
    """Point ``wrapper.<lib_attr>()`` at the library ``path``, a variant
    build with the same C interface: its entry points ``names`` take the
    real library's argument types, and the entry points ``keep`` stay the
    real library's."""
    import ctypes
    lib = ctypes.CDLL(path)
    real = getattr(wrapper, lib_attr)()
    for name in keep:
        setattr(lib, name, getattr(real, name))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = getattr(real, name).argtypes
        fn.restype = getattr(real, name).restype
    setattr(wrapper, lib_attr, lambda: lib)
    return lib


def run(script: str, args, child_args=(), timeout: int = 900,
        on_record: Callable[[dict], None] = None) -> List[dict]:
    """Run every version of ``args`` in the order asked, each as
    ``python <script> <child_args> --child=[TREE, CU, FLAGS]``
    (``child_args`` a list, or a function of the version's name giving
    one); the records, each with ``version`` and ``card``. Raises if a
    version fails."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    vs = versions(args)
    order = args.order.split(",") if args.order else list(vs)
    card = cs.card_line()
    records = []
    for name in order:
        tree, cu, flags = vs[name]
        extra = child_args(name) if callable(child_args) else child_args
        proc = subprocess.run(
            [sys.executable, os.path.abspath(script), *extra,
             "--child=" + json.dumps([tree, cu, flags])],
            capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed:\n{proc.stdout[-3000:]}\n"
                               f"{proc.stderr[-3000:]}")
        rec = {"version": name, "card": card,
               **json.loads(proc.stdout.strip().splitlines()[-1])}
        records.append(rec)
        if on_record:
            on_record(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return records
