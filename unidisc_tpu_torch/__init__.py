"""PyTorch / CUDA port of unidisc_tpu for one NVIDIA H100.

The JAX package ``unidisc_tpu`` is the reference; this package mirrors its
layout module by module and never imports it (nor JAX). Every Pallas TPU
kernel on a ported path becomes a hand-written Hopper kernel under
``ops/csrc/``, built with nvcc at first use.
"""
