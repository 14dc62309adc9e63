"""Console + file logging and a JSONL metrics writer (port of
``utils/logging.py``; reference ``tt/utils.py:30-43``)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional


def init_logger(log_file: Optional[str] = None,
                name: Optional[str] = None) -> logging.Logger:
    fmt = logging.Formatter("[%(asctime)s %(levelname)s] %(message)s")
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    for handler in logger.handlers:
        handler.close()
    logger.handlers = [console]
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricsWriter:
    """Scalar metrics as JSON lines in ``<log_dir>/metrics.jsonl`` (in place
    of the reference's tensorboardX ``SummaryWriter``, ``train.py:162-166``)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._fh.write(json.dumps({"tag": tag, "value": float(value),
                                   "step": int(step), "time": time.time()}) + "\n")
