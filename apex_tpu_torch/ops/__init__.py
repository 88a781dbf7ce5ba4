"""Kernel ops of the port: each holds a hand-written Hopper kernel
(``apex_tpu_torch/csrc``) and its plain PyTorch twin."""

from apex_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_with_lse,
                                                mha_reference)
from apex_tpu_torch.ops.layer_norm import layer_norm, rms_norm
from apex_tpu_torch.ops.optim_kernels import (adam_update,
                                              global_grad_norm_and_finite,
                                              lamb_update, segment_stats)
from apex_tpu_torch.ops.paged_attention import (paged_attention,
                                                paged_attention_reference)
from apex_tpu_torch.ops.quant import (fused_dequant_matmul,
                                      fused_dequant_matmul_reference)
from apex_tpu_torch.ops.ring_attention import (from_zigzag, ring_attention,
                                               ring_attention_zigzag,
                                               to_zigzag)
from apex_tpu_torch.ops.scaled_softmax import (
    scaled_masked_softmax, scaled_softmax, scaled_upper_triang_masked_softmax)
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy

__all__ = ["adam_update", "flash_attention", "flash_attention_with_lse",
           "from_zigzag", "fused_dequant_matmul",
           "fused_dequant_matmul_reference", "global_grad_norm_and_finite",
           "lamb_update", "layer_norm", "mha_reference", "paged_attention",
           "paged_attention_reference", "ring_attention",
           "ring_attention_zigzag", "rms_norm", "scaled_masked_softmax",
           "scaled_softmax", "scaled_upper_triang_masked_softmax",
           "segment_stats", "softmax_cross_entropy", "to_zigzag"]
