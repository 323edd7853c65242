"""hunter_bipedal_control_tpu_torch — the PyTorch/CUDA port of the Hunter
NMPC stack, beside the JAX package it mirrors module by module.

The control recursions (Riccati, KKT projections) need true float32
products: TF32 keeps ~3 decimal digits and turns the Riccati to NaN, the
same failure the JAX package avoids by forcing 'highest' matmul precision.
Importing the package therefore turns TF32 off for matmuls and cuDNN;
every entry point re-asserts it (``device.full_fp32``).
"""
from .device import full_fp32, resolve_device  # noqa: F401

full_fp32()

__version__ = "0.1.0"
