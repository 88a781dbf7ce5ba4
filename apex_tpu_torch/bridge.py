"""Weight bridge from the reference's flax GPT parameters to the port.

``gpt_params_from_flax`` maps the tree ``apex_tpu.models.gpt.GPTModel.init``
returns — as plain numpy arrays, e.g. ``jax.tree.map(np.asarray,
variables)`` — onto the state dict of ``apex_tpu_torch.models.GPTModel``.
Both sides keep the reference's ``(out, in)`` weight layout, so every
tensor maps one to one; only the names change (``layer_i`` ->
``layers.i``). Takes numpy, so it imports nothing of JAX.

Any tree shaped like the params maps the same way, so the tests carry the
reference's gradients (``jax.grad`` of ``gpt_loss``) and its Adam moments
(``flat_buffer.unflatten`` of ``FusedAdam.state``) across by name too: the
two optimizers order their flat segments differently (JAX's sorted keys,
the port's ``named_parameters()``), so parity is held per parameter.
"""

from __future__ import annotations

import numpy as np
import torch

_BLOCK_MODULES = ("input_norm", "post_norm", "qkv", "out_proj", "mlp_in",
                  "mlp_out")


def gpt_params_from_flax(variables) -> dict:
    """``{flax params}`` (or ``{"params": ...}``) -> torch state dict."""
    params = variables.get("params", variables)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {"word_embeddings.weight": t(params["word_embeddings"]["weight"]),
          "position_embeddings": t(params["position_embeddings"]),
          "final_norm.weight": t(params["final_norm"]["weight"]),
          "final_norm.bias": t(params["final_norm"]["bias"])}
    layers = sorted((k for k in params if k.startswith("layer_")),
                    key=lambda k: int(k.split("_")[1]))
    for name in layers:
        i = int(name.split("_")[1])
        for mod in _BLOCK_MODULES:
            for leaf in ("weight", "bias"):
                sd[f"layers.{i}.{mod}.{leaf}"] = t(params[name][mod][leaf])
    return sd
