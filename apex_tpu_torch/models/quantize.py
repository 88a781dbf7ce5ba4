"""fp weights -> the state dict of a quantized-serving model.

Counterpart of ``apex_tpu/models/quantize.py`` (``quantize_params_like``,
``quantize_model_params``, ``assert_quantized_loaded``). A model built with
a ``WeightPrecisionPolicy`` (or ``quantize_int8=True``) holds each block
linear's ``weight`` narrow beside a ``scale`` buffer, both placeholders
until loaded; this module quantizes an fp model's (or state dict's)
weights into them, post-training::

    fp = GPTModel(cfg)                                   # trained weights
    qmodel = GPTModel(dataclasses.replace(
        cfg, weight_policy=WeightPrecisionPolicy("int4")))
    qmodel.load_state_dict(quantize_model_params(qmodel, fp))
    assert_quantized_loaded(qmodel)

Entries the target keeps in fp (embeddings, norms, biases) pass through.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn

from apex_tpu_torch.ops.quant import (WeightPrecisionPolicy, quantize_weight,
                                      quantize_weight_fp8,
                                      quantize_weight_int4)

__all__ = ["WeightPrecisionPolicy", "assert_quantized_loaded",
           "quantize_model_params", "quantize_params_like"]

_NARROW = (torch.int8, torch.float8_e4m3fn, torch.uint8)


def _state(obj) -> Mapping[str, torch.Tensor]:
    return obj.state_dict() if isinstance(obj, nn.Module) else obj


def quantize_params_like(target: Mapping[str, torch.Tensor],
                         params_fp: Mapping[str, torch.Tensor]) -> dict:
    """Wherever ``target`` holds a narrow ``<mod>.weight`` beside a
    ``<mod>.scale``, quantize the fp source weight to that kind (int8 and
    fp8 per channel; uint8 is packed int4, its group size read off the
    target scale's group axis); every other entry is the source's."""
    out = {}
    for name, tgt in target.items():
        mod, _, leaf = name.rpartition(".")
        scale_name = f"{mod}.scale"
        if leaf == "scale" and f"{mod}.weight" in target and \
                target[f"{mod}.weight"].dtype in _NARROW:
            continue                          # produced with the weight
        if leaf == "weight" and scale_name in target and tgt.dtype in _NARROW:
            w = params_fp[name]
            if tgt.dtype == torch.int8:
                q, s = quantize_weight(w)
            elif tgt.dtype == torch.float8_e4m3fn:
                q, s = quantize_weight_fp8(w)
            else:
                gs = w.shape[1] // target[scale_name].shape[0]
                q, s = quantize_weight_int4(w, group_size=gs)
            out[name], out[scale_name] = q, s
        else:
            out[name] = params_fp[name]
    return out


def quantize_model_params(qmodel: nn.Module,
                          fp: Union[nn.Module, Mapping[str, torch.Tensor]]
                          ) -> dict:
    """The state dict of ``qmodel`` (built with a weight policy) from an
    fp model or its state dict; load it with ``qmodel.load_state_dict``."""
    with torch.no_grad():
        return quantize_params_like(qmodel.state_dict(), _state(fp))


def assert_quantized_loaded(params) -> None:
    """Raise ``ValueError`` if a quantized model (or state dict) still
    holds its all-zero placeholders, naming the first such weight, or
    holds no quantized weight at all. Call it before serving."""
    checked = 0
    for name, t in _state(params).items():
        if t.dtype in _NARROW:
            checked += 1
            if not bool((t.float() != 0).any()):
                raise ValueError(
                    f"quantized weight {name!r} is all zeros — this model "
                    "looks like it holds its placeholders; load real values "
                    "with quantize_model_params() before serving")
    if checked == 0:
        raise ValueError(
            "no int8/fp8/int4 leaves found — was this model built with a "
            "weight policy (or quantize_int8=True)?")
