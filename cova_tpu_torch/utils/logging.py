"""Logging: stdout plus the per-fold log file, in the reference's format.

Counterpart of ``cova_tpu/utils/logging.py``: the log file is a de-facto
artifact of the reference (every epoch and eval line lands there), so the
format is kept verbatim. In a multi-rank run every rank runs the same loop
and only rank 0 prints and writes, so lines are not repeated and files are
not raced.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from ..parallel.distributed import is_primary


def print_and_log(msg: str, log_file: Optional[str], write_mode: str = "a"):
    if not is_primary():
        return
    print(msg)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        with open(log_file, write_mode) as f:
            f.write(msg + "\n")


class MetricsLogger:
    """One JSON line per event (``train_epoch``, ``val``) into
    ``<results_dir>/metrics.jsonl``; a ``None`` path logs nothing."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, event: str, **fields):
        if not self.path or not is_primary():
            return
        rec = {"ts": time.time(), "event": event, **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
