"""Shared logger of the port (counterpart of ``biscuit_tpu/utils_log.py``,
the stand-in for ``slideflow.util.log``)."""

from __future__ import annotations

import logging
import os

log = logging.getLogger("biscuit_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
    log.addHandler(_h)
    log.setLevel(os.environ.get("BISCUIT_LOGLEVEL", "WARNING").upper())

