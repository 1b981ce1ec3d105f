"""Shared logger and small path/JSON helpers of the port (counterpart of
``biscuit_tpu/utils_log.py``, the stand-ins for ``slideflow.util``'s
``log``, ``bold``, ``path_to_ext`` and ``path_to_name``)."""

from __future__ import annotations

import logging
import os

log = logging.getLogger("biscuit_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
    log.addHandler(_h)
    log.setLevel(os.environ.get("BISCUIT_LOGLEVEL", "WARNING").upper())



def bold(text: str) -> str:
    """ANSI-bold a string (stand-in for sf.util.bold)."""
    return f"\033[1m{text}\033[0m"


def path_to_ext(path: str) -> str:
    """File extension without the dot (stand-in for sf.util.path_to_ext)."""
    _, ext = os.path.splitext(path)
    return ext.lstrip(".")


def path_to_name(path: str) -> str:
    """Filename without directory or extension."""
    return os.path.splitext(os.path.basename(path))[0]


def write_json(data, path: str) -> None:
    import json

    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def read_json(path: str):
    import json

    with open(path) as f:
        return json.load(f)
