"""Shared CLI app runner: init -> body -> shutdown with clean exits.

Port of the part of ``multiverso_tpu/apps/_runner.py`` the word2vec CLI
uses. User-facing errors (bad flag values, fatal checks, IO) log one line
and return exit code 1 instead of a traceback. Telemetry export
(``-telemetry_dir``) and the multi-process launch helpers wait
(ROADMAP A11, A7).
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
