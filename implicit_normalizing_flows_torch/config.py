"""Solver and estimator configuration of the evaluation and training paths.

Mirror of ``implicit_normalizing_flows_tpu/config.py:25-142`` restricted to
the fields the port reads, with the same ``IMNF_*`` environment names and
defaults: each field is read from its environment variable, else takes the
default below.

There is no kernel gate here: the CUDA kernels run for CUDA tensors and
their plain PyTorch versions for CPU tensors (``ops.fused_solve``).
``fused_block`` chooses a path, not a kernel: "1" routes the training
forward at ``--mem-eff False`` through the merged solve and chains
(``ops.fused_block``) on the blocks the JAX package merges on its chip (H*W
>= ``fused_solve_min_hw``); those still launch kernels for CUDA tensors and
run plain versions for CPU tensors.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, fields, replace


@dataclass(frozen=True)
class KernelConfig:
    # phase-1 precision of the fused forward solve: "float32" |
    # "tensorfloat32" (3-pass bf16 split) | "tf32x" (4-pass). The generic
    # solver path (non-recipe nets) runs float32 products whatever it says:
    # the JAX package's "tensorfloat32" there is float32 on a CPU, and the
    # port never uses native TF32.                  [IMNF_SOLVER_PRECISION]
    solver_precision: str = "tensorfloat32"
    # backward implicit-gradient solve precision: "f32" | "bf16".
    #                                                    [IMNF_BWD_PRECISION]
    bwd_precision: str = "bf16"
    # re-attachment VJP precision: "f32" | "bf16" | "tf32".
    #                                               [IMNF_REATTACH_PRECISION]
    reattach_precision: str = "bf16"
    # run the training Neumann estimator in bfloat16.          [IMNF_BF16_EST]
    bf16_est: bool = True
    # precision-ladder stages re-arming still-unconverged examples under the
    # shared budget (comma-separated, ascending); "" disables. [IMNF_SOLVER_TAIL]
    solver_tail: str = "tf32x,f32"
    # phase-1 iteration cap before the ladder; 0 = threshold // 2.
    #                                                     [IMNF_LADDER_START]
    ladder_start: int = 0
    # start the forward solve at z0 = x instead of zeros.   [IMNF_WARM_START]
    warm_start: bool = True
    # forward Broyden budget override (None = the block's). [IMNF_FWD_THRESHOLD]
    fwd_threshold: int | None = None
    # backward Broyden budget override (None = min(4, the block's
    # threshold)).                                       [IMNF_BWD_THRESHOLD]
    bwd_threshold: int | None = None
    # estimator final-term form: "vjp" (the only one ported; "jvp"
    # raises).                                              [IMNF_FINAL_FORM]
    final_form: str = "vjp"
    # per-example stall exit (0 patience disables; guard <= 0 unguarded).
    #            [IMNF_STALL_PATIENCE / IMNF_STALL_RTOL / IMNF_STALL_GUARD]
    stall_patience: int = 5
    stall_rtol: float = 0.05
    stall_guard: float = 3.0
    # first Broyden direction +g instead of -g.             [IMNF_NEWTON_INIT]
    newton_init: bool = True
    # Armijo line search in every Broyden solve (ops/line_search.py;
    # the generic solver's in ops/broyden.py).            [IMNF_LINE_SEARCH]
    line_search: bool = False
    # print per-block solver diagnostics.                  [IMNF_DEBUG_SOLVER]
    debug_solver: bool = False
    # merged forward solve + both nets' Neumann chains in training at
    # --mem-eff False: "0" | "1" (the blocks with H*W >= fused_solve_min_hw).
    #                                                      [IMNF_FUSED_BLOCK]
    fused_block: str = "0"
    # the merged forward takes the blocks with H*W >= this (the 8x8 blocks
    # of the CIFAR-10 flagship stay split). Only that gate reads it: the
    # JAX package's variable also sends its split solve (of reps*H*W, lane
    # packing) off the fused kernel, while the port's split path runs its
    # kernels at every size.                         [IMNF_FUSED_SOLVE_MIN_HW]
    fused_solve_min_hw: int = 256

    def __post_init__(self):
        if self.fused_block not in ("0", "1"):
            hint = (" ('interpret' is the JAX package's CPU mode: the port runs the "
                    "plain versions on CPU tensors by itself, and IMNF_FUSED_SOLVE_MIN_HW=0 "
                    "merges every block)" if self.fused_block == "interpret" else "")
            raise ValueError(f"IMNF_FUSED_BLOCK={self.fused_block!r}: the port takes "
                             f"'0' | '1'{hint}")


_ENV_BY_FIELD = {
    "solver_precision": "IMNF_SOLVER_PRECISION",
    "bwd_precision": "IMNF_BWD_PRECISION",
    "reattach_precision": "IMNF_REATTACH_PRECISION",
    "bf16_est": "IMNF_BF16_EST",
    "solver_tail": "IMNF_SOLVER_TAIL",
    "ladder_start": "IMNF_LADDER_START",
    "warm_start": "IMNF_WARM_START",
    "fwd_threshold": "IMNF_FWD_THRESHOLD",
    "bwd_threshold": "IMNF_BWD_THRESHOLD",
    "final_form": "IMNF_FINAL_FORM",
    "stall_patience": "IMNF_STALL_PATIENCE",
    "stall_rtol": "IMNF_STALL_RTOL",
    "stall_guard": "IMNF_STALL_GUARD",
    "newton_init": "IMNF_NEWTON_INIT",
    "line_search": "IMNF_LINE_SEARCH",
    "debug_solver": "IMNF_DEBUG_SOLVER",
    "fused_block": "IMNF_FUSED_BLOCK",
    "fused_solve_min_hw": "IMNF_FUSED_SOLVE_MIN_HW",
}


def _coerce(f, raw):
    t = f.type if isinstance(f.type, str) else f.type.__name__
    if t == "bool":
        return raw not in ("0", "", "false", "False")
    if t.startswith("int"):
        return int(raw)
    if t == "float":
        return float(raw)
    return raw


def kernel_config() -> KernelConfig:
    kwargs = {}
    for f in fields(KernelConfig):
        raw = os.environ.get(_ENV_BY_FIELD[f.name])
        if raw is not None:
            kwargs[f.name] = _coerce(f, raw)
    return replace(KernelConfig(), **kwargs)
