"""Experiment logging: console + per-experiment file — port of
``mxdetection_tpu.utils.logger`` (the same code).

Writes ``<workdir>/<date>.log``; the samples/sec role is covered by the
trainer's imgs_per_sec metric.
"""

from __future__ import annotations

import logging
import os
import time


def create_logger(workdir: str, name: str = "mxdetection_tpu") -> logging.Logger:
    os.makedirs(workdir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        fh = logging.FileHandler(
            os.path.join(workdir, time.strftime("%Y-%m-%d-%H-%M-%S") + ".log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
