"""Configs of the port: its own dataclass tree (``core.py``) and zoo (``zoo.py``)."""

from __future__ import annotations

import os

from .core import (  # noqa: F401
    AnchorCfg,
    BackboneCfg,
    BboxHeadCfg,
    CascadeCfg,
    Config,
    DataCfg,
    FPNCfg,
    MaskHeadCfg,
    OptimCfg,
    RetinaHeadCfg,
    RfcnHeadCfg,
    RoiCfg,
    RpnCfg,
    TestCfg,
    TrainCfg,
)
from .zoo import ZOO


def load_config(name_or_path: str, overrides: dict | None = None) -> Config:
    """Zoo config by name (``"faster_rcnn_r50_fpn_1x"``) or by the path of
    its file (``"configs/faster_rcnn_r50_fpn_1x.py"``), looked up by basename.

    The file itself is never executed: it imports the JAX package.
    """
    name = os.path.splitext(os.path.basename(name_or_path))[0]
    if name not in ZOO:
        raise KeyError(f"no zoo config {name!r}; known: {sorted(ZOO)}")
    cfg = ZOO[name]()
    if overrides:
        cfg = cfg.override(**overrides)
    return cfg
