"""Configs of the port: the JAX package's framework-free config system.

``mxdetection_tpu.config`` and ``configs/*.py`` import only the standard
library, so the port reuses them as they are rather than keeping a second
copy of every default. This module is the port's one entry point to them:
the port's modules and ``chip_smoke.py`` import ``Config`` and
``load_config`` from here and name no other module of ``mxdetection_tpu``.
"""

from mxdetection_tpu.config import Config, load_config

__all__ = ["Config", "load_config"]
