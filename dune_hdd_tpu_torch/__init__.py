"""dune_hdd_tpu_torch — the PyTorch / CUDA port of dune_hdd_tpu.

Module paths mirror the JAX package's.  Host geometry is numpy; per-call
work is torch on an explicit ``device``; the structured plane SpMV is a
hand-written CUDA kernel (``csrc/plane_spmv.cu``) built with nvcc at first
use.  This package never imports jax.
"""

__version__ = "0.1.0"
