"""Weight bridge from the reference's flax parameters to the port.

``gpt_params_from_flax`` maps the tree ``apex_tpu.models.gpt.GPTModel.init``
returns — as plain numpy arrays, e.g. ``jax.tree.map(np.asarray,
variables)`` — onto the state dict of ``apex_tpu_torch.models.GPTModel``;
``bert_params_from_flax`` does the same for ``BertForPreTraining``. Both
sides keep the reference's weight layouts (GPT's ``(out, in)`` linears,
BERT's ``(in, out)`` ``x @ W``), so every tensor maps one to one; only the
names change (``layer_i`` -> ``layers.i``, ``/`` -> ``.``). Takes numpy,
so it imports nothing of JAX.

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


#: BertForPreTraining's leaves outside the encoder layers, flax paths
_BERT_TOP = ("word_embeddings", "position_embeddings",
             "token_type_embeddings", "embedding_norm/weight",
             "embedding_norm/bias", "mlm_dense_weight", "mlm_dense_bias",
             "mlm_output_bias", "mlm_norm/weight", "mlm_norm/bias",
             "pooler_weight", "pooler_bias", "nsp_weight", "nsp_bias")
#: the leaves of one encoder layer ``layer_i``
_BERT_LAYER = ("attention/qkv_weight", "attention/qkv_bias",
               "attention/out_weight", "attention/out_bias",
               "attention_norm/weight", "attention_norm/bias",
               "mlp_weight1", "mlp_bias1", "mlp_weight2", "mlp_bias2",
               "mlp_norm/weight", "mlp_norm/bias")


def _flat_paths(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if hasattr(val, "items"):
            yield from _flat_paths(val, path + "/")
        else:
            yield path, val


def bert_params_from_flax(variables) -> dict:
    """``{flax params}`` (or ``{"params": ...}``) of the reference's
    ``BertForPreTraining`` -> torch state dict. Every leaf maps; a leaf the
    port has no place for, or a missing one, raises ``KeyError``."""
    params = variables.get("params", variables)
    sd, layers = {}, set()
    for path, leaf in _flat_paths(params):
        head, _, rest = path.partition("/")
        if (head.startswith("layer_") and head[len("layer_"):].isdigit()
                and rest in _BERT_LAYER):
            i = int(head[len("layer_"):])
            layers.add(i)
            name = f"layers.{i}.{rest.replace('/', '.')}"
        elif path in _BERT_TOP:
            name = path.replace("/", ".")
        else:
            raise KeyError(f"flax leaf {path!r} has no counterpart in the "
                           f"port's BertForPreTraining")
        sd[name] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    want = {p.replace("/", ".") for p in _BERT_TOP}
    want |= {f"layers.{i}.{p.replace('/', '.')}" for i in range(len(layers))
             for p in _BERT_LAYER}
    missing = sorted(want - set(sd))
    if missing:
        raise KeyError(f"flax tree lacks {missing}")
    return sd
