"""Enums of the transformer building blocks: the port's own copy of
``apex_tpu/transformer/enums.py`` (itself mirroring
``apex/transformer/enums.py``), kept here so that the port imports nothing
of the JAX package."""

import enum


class LayerType(enum.Enum):
    encoder = 1
    decoder = 2


class AttnType(enum.Enum):
    self_attn = 1
    cross_attn = 2


class AttnMaskType(enum.Enum):
    padding = 1
    causal = 2


class ModelType(enum.Enum):
    encoder_or_decoder = 1
    encoder_and_decoder = 2
