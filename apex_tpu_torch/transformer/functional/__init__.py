"""Functional building blocks of the port (the counterpart of
``apex_tpu/transformer/functional``)."""

from apex_tpu_torch.transformer.functional.fused_rope import (
    fused_apply_rotary_pos_emb, fused_apply_rotary_pos_emb_cached)
from apex_tpu_torch.transformer.functional.fused_softmax import (
    FusedScaleMaskSoftmax, ScaledMaskedSoftmax, ScaledSoftmax,
    ScaledUpperTriangMaskedSoftmax)

__all__ = ["FusedScaleMaskSoftmax", "ScaledMaskedSoftmax", "ScaledSoftmax",
           "ScaledUpperTriangMaskedSoftmax", "fused_apply_rotary_pos_emb",
           "fused_apply_rotary_pos_emb_cached"]
