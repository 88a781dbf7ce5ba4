"""Kernel ops of the port: each holds a hand-written Hopper kernel
(``apex_tpu_torch/csrc``) and its plain PyTorch twin."""

from apex_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_with_lse,
                                                mha_reference)
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.ops.optim_kernels import (adam_update,
                                              global_grad_norm_and_finite,
                                              lamb_update, segment_stats)
from apex_tpu_torch.ops.paged_attention import (paged_attention,
                                                paged_attention_reference)
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy

__all__ = ["adam_update", "flash_attention", "flash_attention_with_lse",
           "global_grad_norm_and_finite", "lamb_update", "layer_norm",
           "mha_reference", "paged_attention", "paged_attention_reference",
           "segment_stats", "softmax_cross_entropy"]
