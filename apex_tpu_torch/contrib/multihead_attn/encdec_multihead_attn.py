"""EncdecMultiheadAttn: the fused encoder-decoder cross-attention block.

Counterpart of ``apex_tpu/contrib/multihead_attn/encdec_multihead_attn.py``:
q projected from the decoder's query, K and V from the encoder output by
one packed ``kv_weight [2e, e]`` (key must be value, as the reference
asserts), no projection bias (the reference refuses one), and with
``include_norm_add`` a pre-LayerNorm on the query side and the residual
add. Layout, init, amp and dropout as ``SelfMultiheadAttn``.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.contrib.multihead_attn._core import masks_to_bias
from apex_tpu_torch.contrib.multihead_attn.self_multihead_attn import (
    NEED_WEIGHTS, _AttnParams)


class EncdecMultiheadAttn(_AttnParams):
    """Drop-in for ``apex.contrib.multihead_attn.EncdecMultiheadAttn``:
    ``forward(query, key, value, key_padding_mask=None, need_weights=False,
    attn_mask=None, is_training=True)`` returns ``(out, None)``."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", *, param_dtype=torch.float32,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        if bias:
            raise ValueError(
                "EncdecMultiheadAttn does not support bias (reference "
                "apex/contrib/multihead_attn/encdec_multihead_attn.py asserts "
                "the same)")
        self._setup(embed_dim, num_heads, dropout, include_norm_add, impl,
                    param_dtype, device, dropout_generator)
        e = embed_dim
        self.q_weight = self._weight(e)
        self.kv_weight = self._weight(2 * e)
        self.out_proj_weight = self._weight(e)
        self._norm_params()
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    def forward(self, query, key, value,
                key_padding_mask: Optional[torch.Tensor] = None,
                need_weights: bool = False,
                attn_mask: Optional[torch.Tensor] = None,
                is_training: bool = True):
        if need_weights:
            raise NotImplementedError(NEED_WEIGHTS)
        if value is not None and value is not key:
            raise ValueError(
                "EncdecMultiheadAttn packs K and V from the same input; pass "
                "value=key (or None)")
        sq, b, _ = query.shape
        x, dt = self._pre(query)
        q = x.to(dt) @ self.q_weight.to(dt).T
        k, v = (key.to(dt) @ self.kv_weight.to(dt).T).chunk(2, dim=-1)
        bias = masks_to_bias(key_padding_mask, attn_mask, False)
        ctx = self._attend(q, k, v, bias, sq, b, is_training)
        out = ctx @ self.out_proj_weight.to(dt).T
        if self.include_norm_add:
            out = out + query
        return out, None
