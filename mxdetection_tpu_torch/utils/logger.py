"""Experiment logging: console + per-experiment file — port of
``mxdetection_tpu.utils.logger`` (the same code).

Writes ``<workdir>/<date>.log`` (with ``to_file``; a data-parallel run's
other ranks log to stderr alone); the samples/sec role is covered by the
trainer's imgs_per_sec metric.
"""

from __future__ import annotations

import logging
import os
import time


def create_logger(workdir: str, name: str = "mxdetection_tpu",
                  to_file: bool = True) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if to_file and not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
        os.makedirs(workdir, exist_ok=True)
        fh = logging.FileHandler(
            os.path.join(workdir, time.strftime("%Y-%m-%d-%H-%M-%S") + ".log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
