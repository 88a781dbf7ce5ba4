"""Transformer building blocks of the port: ``functional`` (RoPE,
``FusedScaleMaskSoftmax``), ``tensor_parallel`` (the Megatron layers,
regions and vocab-parallel loss at any tensor-parallel size), ``enums``,
``parallel_state`` (the tensor- and data-parallel process groups, the
context-parallel ring), ``utils``."""

from apex_tpu_torch.transformer.enums import (AttnMaskType, AttnType,
                                              LayerType, ModelType)

__all__ = ["AttnMaskType", "AttnType", "LayerType", "ModelType"]
