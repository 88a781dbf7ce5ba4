"""Counterpart of ``apex_tpu.contrib.multihead_attn``."""

from apex_tpu_torch.contrib.multihead_attn.encdec_multihead_attn import (
    EncdecMultiheadAttn)
from apex_tpu_torch.contrib.multihead_attn.self_multihead_attn import (
    SelfMultiheadAttn)

__all__ = ["EncdecMultiheadAttn", "SelfMultiheadAttn"]
