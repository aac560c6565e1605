"""Shared CLI app runner: init -> body -> shutdown with clean exits.

Port of the part of ``multiverso_tpu/apps/_runner.py`` the word2vec CLI
and the serving plane use. User-facing errors (bad flag values, fatal
checks, IO) log one line and return exit code 1 instead of a traceback.
Telemetry export (``-telemetry_dir``) and the multi-process launch
helpers wait (ROADMAP A11, A7).
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.utils import configure
from multiverso_tpu_torch.utils.configure import FlagError
from multiverso_tpu_torch.utils.log import FatalError, log

_USER_ERRORS = (FlagError, FatalError, OSError)


def run_app(body: Callable[[List[str]], int],
            argv: Optional[List[str]] = None) -> int:
    """Parse flags + start the runtime, run ``body(remaining_argv)``,
    always shut down. Returns a process exit code."""
    try:
        remaining = mv.init(argv if argv is not None else sys.argv[1:])
    except _USER_ERRORS as e:
        log.error("%s", e)
        return 1
    try:
        if configure.get_flag("telemetry_dir"):
            raise NotImplementedError(
                "telemetry export (-telemetry_dir) is not ported yet: "
                "ROADMAP A11")
        return body(remaining)
    except _USER_ERRORS as e:
        log.error("%s", e)
        return 1
    finally:
        mv.shutdown()


def serve_config() -> dict:
    """Resolve the ``-serve_*`` flags into the kwargs
    :meth:`ServingService.register_runner` takes, plus the listener
    address (the JAX package's ``apps/_runner.py::serve_config``)."""
    from multiverso_tpu_torch.serving.quant import STORAGE_DTYPES
    from multiverso_tpu_torch.utils.log import FatalError

    get_flag = configure.get_flag
    raw = str(get_flag("serve_buckets"))
    try:
        buckets = tuple(int(b) for b in raw.split(",") if b.strip())
    except ValueError:
        raise FatalError(f"bad -serve_buckets value '{raw}' "
                         "(want e.g. '8,16,32,64')") from None
    if not buckets:
        raise FatalError("-serve_buckets must name at least one bucket")
    depth_raw = str(get_flag("serve_pipeline_depth")).strip().lower()
    if depth_raw not in ("", "auto"):
        try:
            int(depth_raw)
        except ValueError:
            raise FatalError(f"bad -serve_pipeline_depth value "
                             f"'{depth_raw}' (want an int or 'auto')") \
                from None
    kv_dtype = str(get_flag("serve_kv_dtype")).strip().lower() or "f32"
    table_dtype = str(get_flag("serve_table_dtype")).strip().lower() \
        or "f32"
    for name, val in (("-serve_kv_dtype", kv_dtype),
                      ("-serve_table_dtype", table_dtype)):
        if val not in STORAGE_DTYPES:
            raise FatalError(f"bad {name} value '{val}' "
                             f"(want one of {', '.join(STORAGE_DTYPES)})")
    return {
        "host": str(get_flag("serve_host")),
        "port": int(get_flag("serve_port")),
        "buckets": buckets,
        "max_batch": int(get_flag("serve_max_batch")),
        "max_wait_ms": float(get_flag("serve_max_wait_ms")),
        "max_queue": int(get_flag("serve_admission")),
        "pipeline_depth": depth_raw or "auto",
        "cache_rows": int(get_flag("serve_cache_rows")),
        "cache_staleness": int(get_flag("serve_cache_staleness")),
        "cache_mem_budget": int(get_flag("serve_cache_mem_budget")),
        "continuous": bool(get_flag("serve_continuous")),
        "paged": bool(get_flag("serve_paged_kv")),
        "kv_page": int(get_flag("serve_kv_page")),
        "kv_pages": int(get_flag("serve_kv_pages")),
        "kv_dtype": kv_dtype,
        "table_dtype": table_dtype,
        "prefix_entries": int(get_flag("serve_prefix_cache")),
    }


def comm_config() -> dict:
    """Resolve ``-comm_policy`` / ``-comm_policy_overrides`` into the
    model-config fields. Only the default plane is ported (A7)."""
    policy = str(configure.get_flag("comm_policy")).strip().lower()
    overrides = str(configure.get_flag("comm_policy_overrides")).strip()
    if policy or overrides:
        raise NotImplementedError(
            "-comm_policy / -comm_policy_overrides are not ported yet: "
            "ROADMAP A7")
    return {"comm_policy": None, "comm_policy_overrides": None}


def _flag_value(args: List[str], name: str) -> Optional[str]:
    """Raw-argv value of ``-name=v`` (or ``--name=v``); last one wins."""
    for a in reversed(args):
        stripped = a.lstrip("-")
        if stripped.startswith(f"{name}="):
            return stripped.split("=", 1)[1]
    return None


def pin_device_if_requested(args: List[str], device_flag: str) -> None:
    """Single-process mode runs on the card unless the user explicitly
    passes ``-<device_flag>=cpu``, which selects ``-platform=cpu``."""
    if _flag_value(args, device_flag) == "cpu":
        configure.set_flag("platform", "cpu")
