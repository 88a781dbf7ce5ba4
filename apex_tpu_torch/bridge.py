"""Weight bridge from the reference's flax parameters to the port.

``gpt_params_from_flax`` maps the tree ``apex_tpu.models.gpt.GPTModel.init``
returns — as plain numpy arrays, e.g. ``jax.tree.map(np.asarray,
variables)`` — onto the state dict of ``apex_tpu_torch.models.GPTModel``;
``bert_params_from_flax`` does the same for ``BertForPreTraining`` and
``llama_params_from_flax`` for ``LlamaModel``, ``t5_params_from_flax``
for ``T5Model`` and ``resnet_params_from_flax`` for the ImageNet example's
``ResNet`` (its convolutions change layout: HWIO to OIHW) and
``group_norm_params_from_flax`` for ``contrib.group_norm.GroupNorm``,
``multihead_attn_params_from_flax`` for ``contrib.multihead_attn``'s two
modules and ``nmt_params_from_flax`` for the NMT example's
``NMTTransformer`` (its FFN kernels change layout: ``(in, out)`` to
``nn.Linear``'s ``(out, in)``). All
sides keep the reference's weight layouts (GPT's and Llama's ``(out, in)``
linears, BERT's ``(in, out)`` ``x @ W``), so every tensor maps one to one;
only the names change (``layer_i`` -> ``layers.i``, ``/`` -> ``.``). Takes
numpy, so it imports nothing of JAX.

A quantized GPT or Llama tree (a reference model built with a weight
policy) maps too: narrow leaves keep their dtype (int8; uint8, the packed
int4 nibbles; fp8 e4m3, carried through a uint8 view since
``torch.from_numpy`` does not take ml_dtypes' fp8) and each quantized
linear's ``scale`` maps beside its ``weight``. A leaf with no place in the
port raises ``KeyError``.

Any tree shaped like the params maps the same way, so the tests carry the
reference's gradients (``jax.grad`` of ``gpt_loss``) and its Adam moments
(``flat_buffer.unflatten`` of ``FusedAdam.state``) across by name too: the
two optimizers order their flat segments differently (JAX's sorted keys,
the port's ``named_parameters()``), so parity is held per parameter.
"""

from __future__ import annotations

import numpy as np
import torch

#: GPTModel's leaves outside the decoder blocks, flax paths
_GPT_TOP = ("word_embeddings/weight", "position_embeddings",
            "final_norm/weight", "final_norm/bias")
#: the leaves of one decoder block ``layer_i``; a quantized linear adds a
#: ``scale`` beside its narrow ``weight``
_GPT_LAYER = tuple(f"{mod}/{leaf}" for mod in ("input_norm", "post_norm")
                   for leaf in ("weight", "bias")) + tuple(
    f"{mod}/{leaf}" for mod in ("qkv", "out_proj", "mlp_in", "mlp_out")
    for leaf in ("weight", "bias", "scale"))


def _tensor(a) -> torch.Tensor:
    """A numpy leaf as a tensor: int8 and uint8 as they are, fp8 e4m3
    through a uint8 view, every other float as fp32."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(np.array(a).view(np.uint8)).view(
            torch.float8_e4m3fn)
    if a.dtype in (np.int8, np.uint8):
        return torch.from_numpy(np.array(a))
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _split_layer(path: str):
    """``"layer_3/qkv/weight"`` -> ``(3, "qkv/weight")``; ``(None, path)``
    outside the numbered layers."""
    head, _, rest = path.partition("/")
    if head.startswith("layer_") and head[len("layer_"):].isdigit():
        return int(head[len("layer_"):]), rest
    return None, path


def gpt_params_from_flax(variables) -> dict:
    """``{flax params}`` (or ``{"params": ...}``) of the reference's
    ``GPTModel``, quantized or not -> torch state dict. A leaf the port has
    no place for raises ``KeyError``."""
    params = variables.get("params", variables)
    sd = {}
    for path, leaf in _flat_paths(params):
        i, rest = _split_layer(path)
        if i is not None and rest in _GPT_LAYER:
            name = f"layers.{i}.{rest.replace('/', '.')}"
        elif i is None and path in _GPT_TOP:
            name = path.replace("/", ".")
        else:
            raise KeyError(f"flax leaf {path!r} has no counterpart in the "
                           f"port's GPTModel")
        sd[name] = _tensor(leaf)
    return sd


#: LlamaModel's leaves outside the decoder blocks, flax paths
_LLAMA_TOP = ("embed_tokens/weight", "final_norm/weight", "lm_head/weight")
#: the leaves of one Llama block ``layer_i``; a quantized linear adds a
#: ``scale`` beside its narrow ``weight``
_LLAMA_LAYER = ("input_norm/weight", "post_norm/weight") + tuple(
    f"{mod}/{leaf}" for mod in ("q_proj", "kv_proj", "o_proj",
                                "gate_up_proj", "down_proj")
    for leaf in ("weight", "scale"))


def llama_params_from_flax(variables) -> dict:
    """``{flax params}`` (or ``{"params": ...}``) of the reference's
    ``LlamaModel``, quantized or not -> torch state dict. A leaf the port
    has no place for raises ``KeyError``."""
    params = variables.get("params", variables)
    sd = {}
    for path, leaf in _flat_paths(params):
        i, rest = _split_layer(path)
        if i is not None and rest in _LLAMA_LAYER:
            name = f"layers.{i}.{rest.replace('/', '.')}"
        elif i is None and path in _LLAMA_TOP:
            name = path.replace("/", ".")
        else:
            raise KeyError(f"flax leaf {path!r} has no counterpart in the "
                           f"port's LlamaModel")
        sd[name] = _tensor(leaf)
    return sd


#: T5Model's leaves outside the blocks, flax paths (``lm_head`` untied only)
_T5_TOP = ("shared/weight", "enc_rel_bias/rel_attn_bias",
           "dec_rel_bias/rel_attn_bias", "enc_final_norm/weight",
           "dec_final_norm/weight", "lm_head/weight")
#: the leaves of one encoder block ``enc_i`` and one decoder block ``dec_i``
_T5_ENC = ("attn_norm/weight", "self_attn/qkv/weight",
           "self_attn/out/weight", "ffn_norm/weight", "ffn/wi/weight",
           "ffn/wo/weight")
_T5_DEC = _T5_ENC + ("cross_norm/weight", "cross_attn/q/weight",
                     "cross_attn/kv/weight", "cross_attn/out/weight")


def t5_params_from_flax(variables) -> dict:
    """``{flax params}`` (or ``{"params": ...}``) of the reference's
    ``T5Model`` -> torch state dict: ``enc_i``/``dec_i`` map to
    ``enc_blocks.i``/``dec_blocks.i``, the rest keep their names. A leaf the
    port has no place for raises ``KeyError``."""
    params = variables.get("params", variables)
    sd = {}
    for path, leaf in _flat_paths(params):
        head, _, rest = path.partition("/")
        side, _, idx = head.partition("_")
        leaves = {"enc": _T5_ENC, "dec": _T5_DEC}.get(side, ())
        if idx.isdigit() and rest in leaves:
            name = f"{side}_blocks.{idx}.{rest.replace('/', '.')}"
        elif path in _T5_TOP:
            name = path.replace("/", ".")
        else:
            raise KeyError(f"flax leaf {path!r} has no counterpart in the "
                           f"port's T5Model")
        sd[name] = _tensor(leaf)
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
        i, rest = _split_layer(path)
        if i is not None and rest in _BERT_LAYER:
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


#: the ImageNet ResNet's flax module names -> the port's: a bottleneck's
#: unnamed convolutions ``Conv_k``, in call order, and its named modules;
#: the stem's ``conv1``/``bn1`` and ``fc`` at the top
_RESNET_BLOCK_CONV = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3",
                      "downsample_conv": "downsample_conv"}
_RESNET_BLOCK_BN = ("bn1", "bn2", "bn3", "downsample_bn")
_RESNET_BN_LEAF = {"weight": "weight", "bias": "bias", "mean": "running_mean",
                   "var": "running_var"}


def _resnet_name(path: str) -> str:
    """A flax ``params`` or ``batch_stats`` path of the ResNet -> the port's
    state-dict name, or ``KeyError``."""
    parts = path.split("/")
    block = parts[0].startswith("stage") and "_block" in parts[0]
    prefix, rest = (parts[:1], parts[1:]) if block else ([], parts)
    convs = _RESNET_BLOCK_CONV if block else {"conv1": "conv1"}
    bns = _RESNET_BLOCK_BN if block else ("bn1",)
    if len(rest) == 2:
        mod, leaf = rest
        if mod in convs and leaf == "kernel":
            return ".".join(prefix + [convs[mod], "weight"])
        if mod in bns and leaf in _RESNET_BN_LEAF:
            return ".".join(prefix + [mod, _RESNET_BN_LEAF[leaf]])
        if not block and mod == "fc" and leaf in ("kernel", "bias"):
            return "fc." + ("weight" if leaf == "kernel" else "bias")
    raise KeyError(f"flax leaf {path!r} has no counterpart in the port's "
                   f"ResNet")


def resnet_params_from_flax(variables) -> dict:
    """``{"params": ..., "batch_stats": ...}`` of the reference example's
    ``ResNet`` (``examples/imagenet/main_amp.py``) -> the state dict of
    ``apex_tpu_torch.examples.imagenet.main_amp.ResNet``: conv kernels HWIO
    -> OIHW, ``fc``'s ``(in, out)`` -> ``(out, in)``, ``batch_stats``
    ``mean``/``var`` -> ``running_mean``/``running_var``. Any leaf left
    unmapped raises ``KeyError``; a tree without ``batch_stats`` maps the
    parameters alone."""
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flat_paths(variables.get(coll, {})):
            name = _resnet_name(path)
            t = _tensor(leaf)
            if name.endswith("weight") and t.ndim == 4:
                t = t.permute(3, 2, 0, 1)
            elif name == "fc.weight":
                t = t.t()
            sd[name] = t.contiguous()
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"flax collections {sorted(extra)} have no "
                       f"counterpart in the port's ResNet")
    return sd


def group_norm_params_from_flax(variables) -> dict:
    """``{"params": {"weight", "bias"}}`` of the reference's
    ``contrib.group_norm.GroupNorm`` -> the state dict of the port's
    ``GroupNorm`` (``{}`` for ``affine=False``, whose tree has no params).
    Any other leaf or collection raises ``KeyError``."""
    extra = set(variables) - {"params"}
    if extra:
        raise KeyError(f"flax collections {sorted(extra)} have no "
                       f"counterpart in the port's GroupNorm")
    sd = {}
    for path, leaf in _flat_paths(variables.get("params", {})):
        if path not in ("weight", "bias"):
            raise KeyError(f"flax leaf {path!r} has no counterpart in the "
                           f"port's GroupNorm")
        sd[path] = _tensor(leaf)
    return sd


#: the leaves of ``SelfMultiheadAttn`` / ``EncdecMultiheadAttn``, kept in
#: torch's ``(out, in)`` layout by the reference, so they map as they are
_MHA_NORM = ("lyr_nrm_gamma_weights", "lyr_nrm_beta_weights")
_MHA_LEAVES = ("qkv_weight", "q_weight", "k_weight", "v_weight", "kv_weight",
               "qkv_bias", "q_bias", "k_bias", "v_bias", "out_proj_weight",
               "out_proj_bias") + _MHA_NORM


def _mha_want(leaves) -> set:
    """The leaf set an attention module with ``leaves`` must have: the
    output projection, one layout of the input projections (packed QKV,
    q + packed KV, or separate q/k/v), their biases if any bias is there,
    and both norm parameters if either is."""
    have = set(leaves)
    want = {"out_proj_weight"}
    if "kv_weight" in have:
        want |= {"q_weight", "kv_weight"}
    elif "qkv_weight" in have:
        want.add("qkv_weight")
    else:
        want |= {"q_weight", "k_weight", "v_weight"}
    if have & {"qkv_bias", "q_bias", "k_bias", "v_bias", "out_proj_bias"}:
        want.add("out_proj_bias")
        want |= ({"qkv_bias"} if "qkv_weight" in want
                 else {"q_bias", "k_bias", "v_bias"})
    if have & set(_MHA_NORM):
        want |= set(_MHA_NORM)
    return want


def multihead_attn_params_from_flax(variables) -> dict:
    """``{flax params}`` (or ``{"params": ...}``) of the reference's
    ``SelfMultiheadAttn`` or ``EncdecMultiheadAttn`` -> the port module's
    state dict, names and layouts unchanged. A leaf with no counterpart, or
    one missing from the module's layout, raises ``KeyError``."""
    params = variables.get("params", variables)
    sd = {}
    for path, leaf in _flat_paths(params):
        if path not in _MHA_LEAVES:
            raise KeyError(f"flax leaf {path!r} has no counterpart in the "
                           f"port's multihead attention modules")
        sd[path] = _tensor(leaf)
    missing = sorted(_mha_want(sd) - set(sd))
    if missing:
        raise KeyError(f"flax tree lacks {missing}")
    return sd


#: an NMT layer's leaves outside its attention modules (flax path ->
#: port name; a ``kernel`` is transposed)
_NMT_FFN = {"ffn_norm/weight": "ffn_norm.weight",
            "ffn_norm/bias": "ffn_norm.bias",
            "fc1/kernel": "fc1.weight", "fc1/bias": "fc1.bias",
            "fc2/kernel": "fc2.weight", "fc2/bias": "fc2.bias"}
_NMT_TOP = ("embed", "pos", "enc_norm/weight", "enc_norm/bias",
            "dec_norm/weight", "dec_norm/bias")
#: the attention modules of an encoder and a decoder layer, and their
#: leaves (both ``include_norm_add``, no bias, packed projections)
_NMT_ATTN = {"enc": {"self_attn": ("qkv_weight", "out_proj_weight")
                     + _MHA_NORM},
             "dec": {"self_attn": ("qkv_weight", "out_proj_weight")
                     + _MHA_NORM,
                     "cross_attn": ("q_weight", "kv_weight",
                                    "out_proj_weight") + _MHA_NORM}}


def _nmt_name(path: str) -> str:
    """A flax path of ``NMTTransformer`` -> the port's name, or
    ``KeyError``."""
    if path in _NMT_TOP:
        return path.replace("/", ".")
    head, _, rest = path.partition("/")
    side, _, idx = head.partition("_")
    if side in _NMT_ATTN and idx.isdigit():
        prefix = f"{side}_layers.{int(idx)}."
        if rest in _NMT_FFN:
            return prefix + _NMT_FFN[rest]
        mod, _, leaf = rest.partition("/")
        if leaf in _NMT_ATTN[side].get(mod, ()):
            return prefix + f"{mod}.{leaf}"
    raise KeyError(f"flax leaf {path!r} has no counterpart in the port's "
                   f"NMTTransformer")


def nmt_params_from_flax(variables) -> dict:
    """``{flax params}`` (or ``{"params": ...}``) of the reference
    example's ``NMTTransformer`` (``examples/nmt/main.py``) -> the state
    dict of ``apex_tpu_torch.examples.nmt.main.NMTTransformer``: the FFN
    kernels ``(in, out)`` -> ``(out, in)``, every other leaf as it is. A
    leaf with no counterpart, or a missing one, raises ``KeyError``."""
    params = variables.get("params", variables)
    sd, layers = {}, {"enc": set(), "dec": set()}
    for path, leaf in _flat_paths(params):
        name = _nmt_name(path)
        t = _tensor(leaf)
        if path.endswith("/kernel"):
            t = t.t().contiguous()
        sd[name] = t
        side, _, idx = path.partition("/")[0].partition("_")
        if side in layers and idx.isdigit():
            layers[side].add(int(idx))
    want = {p.replace("/", ".") for p in _NMT_TOP}
    for side, mods in _NMT_ATTN.items():
        n = max(layers[side], default=-1) + 1
        for i in range(n):
            want |= {f"{side}_layers.{i}.{v}" for v in _NMT_FFN.values()}
            want |= {f"{side}_layers.{i}.{mod}.{leaf}"
                     for mod, leaves in mods.items() for leaf in leaves}
    missing = sorted(want - set(sd))
    if missing:
        raise KeyError(f"flax tree lacks {missing}")
    return sd
