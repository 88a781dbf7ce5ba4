"""Transformer building blocks of the port (tensor-parallel size 1):
``functional`` (RoPE, ``FusedScaleMaskSoftmax``), ``tensor_parallel``,
``enums``, ``parallel_state`` (the context-parallel ring)."""

from apex_tpu_torch.transformer.enums import (AttnMaskType, AttnType,
                                              LayerType, ModelType)

__all__ = ["AttnMaskType", "AttnType", "LayerType", "ModelType"]
