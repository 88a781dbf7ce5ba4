"""FusedScaleMaskSoftmax: Megatron's attention softmax, fused or unfused.

Counterpart of ``apex_tpu/transformer/functional/fused_softmax.py``. The
three ``Scaled*Softmax`` classes are the reference's autograd entry points
over the scaled-softmax kernels (``apex_tpu_torch/ops/scaled_softmax.py``);
``FusedScaleMaskSoftmax`` keeps the reference's constructor checks and
dispatch: every fused call lands on those kernels, there is no seqlen cap to
fall back around, so ``is_kernel_available`` is the fusion flag alone, and
``forward_torch_softmax`` is the unfused path in plain torch ops (cast,
scale, ``mask_func`` or the ``MASK_FILL`` fill, ``torch.softmax``), as the
reference's is in jnp: no kernel stands behind it there either.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from apex_tpu_torch.ops.scaled_softmax import (
    MASK_FILL, scaled_masked_softmax as _scaled_masked_softmax,
    scaled_softmax as _plain_scaled_softmax,
    scaled_upper_triang_masked_softmax as _scaled_upper_triang)
from apex_tpu_torch.transformer.enums import AttnMaskType


class ScaledUpperTriangMaskedSoftmax:
    """Reference: ScaledUpperTriangMaskedSoftmax autograd fn (causal, 3D
    input)."""

    @staticmethod
    def apply(x, scale):
        return _scaled_upper_triang(x, scale)


class ScaledMaskedSoftmax:
    """Reference: ScaledMaskedSoftmax autograd fn (4D input + bool mask)."""

    @staticmethod
    def apply(x, mask, scale):
        return _scaled_masked_softmax(x, mask, scale)


class ScaledSoftmax:
    """Reference: ScaledSoftmax autograd fn (no mask)."""

    @staticmethod
    def apply(x, scale):
        return _plain_scaled_softmax(x, scale)


class FusedScaleMaskSoftmax(nn.Module):
    """fused operation: scaling + mask + softmax.

    Args, as the reference's:
      input_in_fp16 / input_in_bf16: declared activation dtype.
      attn_mask_type: AttnMaskType.{padding,causal}.
      scaled_masked_softmax_fusion: use the fused kernels.
      mask_func: callable(x, mask) -> masked x, used on the unfused path.
      softmax_in_fp32: upcast before softmax on the unfused path.
      scale: optional scale factor (requires softmax_in_fp32 when set).
    """

    def __init__(self, input_in_fp16: bool = False,
                 input_in_bf16: bool = False,
                 attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        super().__init__()
        if input_in_fp16 and input_in_bf16:
            raise RuntimeError("both fp16 and bf16 flags cannot be active at "
                               "the same time.")
        if scale is not None and not softmax_in_fp32:
            raise RuntimeError("softmax should be in fp32 when scaled")
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        """The reference's CUDA gates (16 < sk <= 4096, sq % 4 == 0, ...)
        do not apply to these kernels, which take any shape: availability
        is the fusion flag."""
        return self.scaled_masked_softmax_fusion

    def forward(self, input, mask=None):
        assert input.ndim == 4
        b, np_, sq, sk = input.shape
        if self.is_kernel_available(mask, b, np_, sq, sk):
            return self.forward_fused_softmax(input, mask)
        return self.forward_torch_softmax(input, mask)

    # reference method names kept for parity
    def forward_fused_softmax(self, input, mask):
        scale = self.scale if self.scale is not None else 1.0
        if self.attn_mask_type == AttnMaskType.causal:
            assert input.shape[2] == input.shape[3], (
                "causal mask is only for self attention")
            x = input.reshape(-1, input.shape[2], input.shape[3])
            probs = ScaledUpperTriangMaskedSoftmax.apply(x, scale)
            return probs.reshape(input.shape)
        return ScaledMaskedSoftmax.apply(input, mask, scale)

    def forward_torch_softmax(self, input, mask):
        orig_dtype = input.dtype
        if self.input_in_float16 and self.softmax_in_fp32:
            input = input.float()
        if self.scale is not None:
            input = input * self.scale
        if self.attn_mask_type == AttnMaskType.causal and mask is None:
            sq, sk = input.shape[2], input.shape[3]
            mask = ~torch.tril(torch.ones((1, 1, sq, sk), dtype=torch.bool,
                                          device=input.device))
        if mask is not None and self.mask_func is not None:
            input = self.mask_func(input, mask)
        elif mask is not None:
            input = input.masked_fill(mask, MASK_FILL)
        probs = torch.softmax(input, dim=-1)
        if self.input_in_float16 and self.softmax_in_fp32:
            probs = probs.to(orig_dtype)
        return probs
