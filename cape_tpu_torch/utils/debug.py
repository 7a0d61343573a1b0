"""Env-var debug toggles — the reference's DEBUG_* family, a copy of
`cape_tpu.utils.debug`.

The reference drives targeted diagnostics through environment variables
(`engine_cape.py:40`, `roomformer_v2.py:474,601,615`,
`eval_cape_checkpoint.py:447,487,970`): DEBUG_CAPE, DEBUG_PCK,
DEBUG_EXTRACT, DEBUG_KEYPOINT_COUNT, DEBUG_EVAL, DEBUG_KEYPOINT_BUG
(per-step token-type trace, `eval/evaluate.py`), DEBUG_VIS (per-episode
numeric dump, `cli/visualize.py`), WARN_INCOMPLETE_GENERATION. Same
contract here: set the variable to 1 to
enable, anything else (or unset) disables. Checks are one dict lookup, and
callers guard message formatting behind `debug_enabled` so disabled
toggles cost nothing.
"""

from __future__ import annotations

import os


def debug_enabled(name: str) -> bool:
    return os.environ.get(name, "0") == "1"


def dbg(name: str, msg: str) -> None:
    """Print `msg` when the `name` env toggle is set to 1."""
    if debug_enabled(name):
        print(f"[{name}] {msg}", flush=True)
