"""SelfMultiheadAttn: the fused self-attention block.

Counterpart of ``apex_tpu/contrib/multihead_attn/self_multihead_attn.py``
(the reference's ``apex/contrib/multihead_attn/self_multihead_attn.py``):
a QKV projection (packed ``qkv_weight`` or ``q/k/v_weight``, optional
biases), the attention core (``impl="fast"``: the flash kernels, dropout
in the kernel; ``impl="default"``: the unfused ground truth), the output
projection, and with ``include_norm_add`` a pre-LayerNorm (the port's
LayerNorm kernels, eps 1e-5) and the residual add. Inputs are ``[seq,
batch, embed_dim]``; weights are ``(out, in)``, the reference's layout and
parameter names, so a flax tree maps one to one. The projections compute
in ``amp.policy.resolve_compute_dtype(x.dtype)`` (amp O1's seam); the
residual add then promotes to the residual's dtype, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.amp.policy import resolve_compute_dtype
from apex_tpu_torch.contrib.multihead_attn._core import (attention_core,
                                                          masks_to_bias)
from apex_tpu_torch.ops.layer_norm import layer_norm

NEED_WEIGHTS = ("need_weights is unsupported by the fused path (same as "
                "the reference fast impl)")


def xavier_uniform_(p: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``xavier_uniform`` (and torch's): uniform in +-sqrt(6 /
    (fan_in + fan_out)) for a 2-D weight, drawn on the CPU ``generator``
    and copied to the parameter's device."""
    bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
    with torch.no_grad():
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                              generator=generator))


class _AttnParams(nn.Module):
    """Parameter set-up shared by both modules: weights by xavier_uniform
    from a CPU generator, biases zero, the norm's gamma one and beta zero;
    a CPU ``dropout_generator`` for the keep masks' seeds."""

    def _setup(self, embed_dim: int, num_heads: int, dropout: float,
               include_norm_add: bool, impl: str, param_dtype, device,
               dropout_generator) -> None:
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        if impl not in ("fast", "default"):
            raise ValueError(f"impl must be 'fast' or 'default', got "
                             f"{impl!r}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.impl = dropout, impl
        self.include_norm_add = include_norm_add
        self._pd = dict(dtype=param_dtype, device=device)
        self.dropout_generator = (dropout_generator if dropout_generator
                                  is not None else torch.Generator()
                                  .manual_seed(0))

    def _weight(self, rows: int) -> nn.Parameter:
        return nn.Parameter(torch.empty(rows, self.embed_dim, **self._pd))

    def _vector(self, n: int, fill: float) -> nn.Parameter:
        return nn.Parameter(torch.full((n,), fill, **self._pd))

    def _norm_params(self) -> None:
        if self.include_norm_add:
            e = self.embed_dim
            self.lyr_nrm_gamma_weights = self._vector(e, 1.0)
            self.lyr_nrm_beta_weights = self._vector(e, 0.0)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """xavier_uniform weights in registration order, zero biases, unit
        gamma, zero beta."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("_weight") and p.ndim == 2:
                    xavier_uniform_(p, generator)
                elif name == "lyr_nrm_gamma_weights":
                    p.fill_(1.0)
                else:
                    p.zero_()

    def _pre(self, query):
        """``(x, compute dtype)``: the query, normed when
        ``include_norm_add``."""
        x = query
        if self.include_norm_add:
            x = layer_norm(x, self.lyr_nrm_gamma_weights,
                           self.lyr_nrm_beta_weights, eps=1e-5)
        return x, resolve_compute_dtype(x.dtype)

    def _attend(self, q, k, v, bias, sq: int, b: int, is_training: bool):
        """q ``[sq, b, e]``, k/v ``[sk, b, e]`` -> the context ``[sq, b,
        e]``."""
        h, e = self.num_heads, self.embed_dim
        d = e // h

        def to_bhsd(t):
            return t.reshape(t.shape[0], b, h, d).permute(1, 2, 0, 3)

        rate = self.dropout if is_training else 0.0
        ctx = attention_core(to_bhsd(q), d, to_bhsd(k), to_bhsd(v), bias,
                             rate, self.impl,
                             generator=self.dropout_generator)
        return ctx.permute(2, 0, 1, 3).reshape(sq, b, e)


class SelfMultiheadAttn(_AttnParams):
    """Drop-in for ``apex.contrib.multihead_attn.SelfMultiheadAttn``.

    ``forward(query, key=None, value=None, key_padding_mask=None,
    need_weights=False, attn_mask=None, is_training=True)`` returns ``(out,
    None)``; key and value are ignored (self attention), as in the
    reference. Parameters live on ``device`` (the card unless the caller
    passes another), drawn from the CPU ``generator`` (seed 0 by default);
    the dropout seeds come from the CPU ``dropout_generator``, which a model
    may share among its layers."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 separate_qkv_params: bool = False,
                 mask_additive: bool = False, impl: str = "fast", *,
                 param_dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self._setup(embed_dim, num_heads, dropout, include_norm_add, impl,
                    param_dtype, device, dropout_generator)
        self.bias = bias
        self.separate_qkv_params = separate_qkv_params
        self.mask_additive = mask_additive
        e = embed_dim
        if separate_qkv_params:
            self.q_weight = self._weight(e)
            self.k_weight = self._weight(e)
            self.v_weight = self._weight(e)
        else:
            self.qkv_weight = self._weight(3 * e)
        if bias:
            if separate_qkv_params:
                self.q_bias = self._vector(e, 0.0)
                self.k_bias = self._vector(e, 0.0)
                self.v_bias = self._vector(e, 0.0)
            else:
                self.qkv_bias = self._vector(3 * e, 0.0)
            self.out_proj_bias = self._vector(e, 0.0)
        self.out_proj_weight = self._weight(e)
        self._norm_params()
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    def forward(self, query, key=None, value=None,
                key_padding_mask: Optional[torch.Tensor] = None,
                need_weights: bool = False,
                attn_mask: Optional[torch.Tensor] = None,
                is_training: bool = True):
        del key, value
        if need_weights:
            raise NotImplementedError(NEED_WEIGHTS)
        sq, b, _ = query.shape
        x, dt = self._pre(query)
        x = x.to(dt)
        if self.separate_qkv_params:
            q = x @ self.q_weight.to(dt).T
            k = x @ self.k_weight.to(dt).T
            v = x @ self.v_weight.to(dt).T
            if self.bias:
                q = q + self.q_bias.to(dt)
                k = k + self.k_bias.to(dt)
                v = v + self.v_bias.to(dt)
        else:
            qkv = x @ self.qkv_weight.to(dt).T
            if self.bias:
                qkv = qkv + self.qkv_bias.to(dt)
            q, k, v = qkv.chunk(3, dim=-1)
        bias = masks_to_bias(key_padding_mask, attn_mask, self.mask_additive)
        ctx = self._attend(q, k, v, bias, sq, b, is_training)
        out = ctx @ self.out_proj_weight.to(dt).T
        if self.bias:
            out = out + self.out_proj_bias.to(dt)
        if self.include_norm_add:
            out = out + query
        return out, None
