"""PyTorch / CUDA port of ``implicit_normalizing_flows_tpu``.

The JAX package beside this one is the reference every module here is held
against. This package imports ``torch`` and numpy only: never ``jax`` and
nothing of the JAX package.

Numerics are pinned at import: float32 convolutions and matmuls run in full
float32, never in native TF32 (10 mantissa bits). The solver's ``tf32`` /
``tf32x`` precision modes are the 3-/4-pass bf16 hi/lo split of the
reference (about 16 mantissa bits), computed explicitly in
``ops.fused_solve``.
"""
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
