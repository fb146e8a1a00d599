"""mxdetection_tpu_torch: the PyTorch + CUDA port of ``mxdetection_tpu``.

The JAX package beside it is the reference each module here is held
against. The port runs on an NVIDIA H100: plain tensor work is PyTorch,
and every TPU Pallas kernel on the ported path is a CUDA kernel written
for ``sm_90a`` (``csrc/``, bound by ``ops/cuda/``).

Layout mirrors ``mxdetection_tpu``: public functions keep its NHWC images
and features and its (B, R, P, P, C) RoI features, with the batch
dimension written out where JAX used ``vmap``. This package imports
``torch``, ``numpy`` and the stdlib; of the JAX package it reuses only the
framework-free ``mxdetection_tpu.config``, through ``config.py``.
"""

__version__ = "0.1.0"
