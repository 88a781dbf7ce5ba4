"""Precision policies: apex.amp's opt levels as a dtype policy.

Counterpart of ``apex_tpu/amp/policy.py``. The reference's O1 per-op cast
lists collapse into a policy that modules consult: the parameter dtype, the
compute dtype, and whether norm parameters stay fp32.
  O0: fp32 everything;
  O1: fp32 parameters, half compute;
  O2: half parameters beside fp32 masters, fp32 norms;
  O3: pure half.
bf16 is the default half type (no loss scaling needed); fp16 engages the
dynamic ``LossScaler``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# parameter-name tokens treated as normalization params for
# keep_batchnorm_fp32
NORM_NAME_TOKENS = ("norm", "bn", "batchnorm", "layernorm")


def is_norm_param_name(path_name: str) -> bool:
    n = path_name.lower()
    return any(t in n for t in NORM_NAME_TOKENS)


@dataclasses.dataclass(frozen=True)
class Policy:
    """What dtype each tensor class uses."""

    opt_level: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    output_dtype: torch.dtype
    keep_norm_fp32: bool  # keep_batchnorm_fp32 in the reference
    master_weights: bool
    loss_scale: Optional[object]  # None, a float, or "dynamic"


# amp's module state, as the reference's: ``(policy, loss scalers)``, set by
# ``amp.initialize`` and ``amp.scope``; ``(None, ())`` is amp off
_active: tuple = (None, ())


def active_state() -> tuple:
    """``(policy or None, loss scalers)``: amp's state as it stands."""
    return _active


def set_active_state(policy: Optional[Policy], scalers=()) -> None:
    global _active
    _active = (policy, tuple(scalers))


def resolve_compute_dtype(default):
    """The dtype modules compute in: the active amp policy's compute dtype
    once ``amp.initialize`` has run, else ``default``. Modules call it at
    forward time, so ``amp.initialize(opt_level="O1")`` flips their compute
    dtype without touching a config."""
    pol = _active[0]
    return default if pol is None else pol.compute_dtype


def make_policy(opt_level: str, half_dtype=torch.bfloat16,
                cast_model_type=None, keep_batchnorm_fp32=None,
                master_weights=None, loss_scale=None) -> Policy:
    """Map an apex opt level and its overrides to a Policy; explicit
    keywords override the level's defaults, as in the reference."""
    opt_level = opt_level.upper()
    half_scale = "dynamic" if half_dtype == torch.float16 else 1.0
    if opt_level == "O0":
        p = dict(param_dtype=torch.float32, compute_dtype=torch.float32,
                 output_dtype=torch.float32, keep_norm_fp32=False,
                 master_weights=False, loss_scale=1.0)
    elif opt_level == "O1":
        p = dict(param_dtype=torch.float32, compute_dtype=half_dtype,
                 output_dtype=torch.float32, keep_norm_fp32=True,
                 master_weights=False, loss_scale=half_scale)
    elif opt_level == "O2":
        p = dict(param_dtype=half_dtype, compute_dtype=half_dtype,
                 output_dtype=torch.float32, keep_norm_fp32=True,
                 master_weights=True, loss_scale=half_scale)
    elif opt_level == "O3":
        p = dict(param_dtype=half_dtype, compute_dtype=half_dtype,
                 output_dtype=half_dtype, keep_norm_fp32=False,
                 master_weights=False, loss_scale=1.0)
    else:
        raise ValueError(f"Unexpected optimization level {opt_level}; "
                         "options are 'O0', 'O1', 'O2', 'O3'.")
    if cast_model_type is not None:
        p["param_dtype"] = cast_model_type
    if keep_batchnorm_fp32 is not None:
        p["keep_norm_fp32"] = keep_batchnorm_fp32
    if master_weights is not None:
        p["master_weights"] = master_weights
    if loss_scale is not None:
        p["loss_scale"] = loss_scale
    return Policy(opt_level=opt_level, **p)
