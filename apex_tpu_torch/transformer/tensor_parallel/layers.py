"""Megatron-style linears and embedding at tensor-parallel size 1.

Counterparts of ``apex_tpu/transformer/tensor_parallel/layers.py``
(``ColumnParallelLinear``, ``RowParallelLinear``,
``VocabParallelEmbedding``). Weights keep the torch/reference layout
``(out, in)`` in ``param_dtype``; the forward casts weight and bias to the
input's dtype and computes ``y = x @ w.T + b``, as the reference does. These
GEMMs sit outside any Pallas kernel in the reference, so they stay
``torch.matmul`` here.
"""

from __future__ import annotations

import torch
from torch import nn

_TP_TODO = ("tensor parallelism (world_size > 1) is not ported yet "
            "(ROADMAP queue A item 10: tensor-parallel serving)")


def _tp1(world_size: int) -> None:
    if world_size != 1:
        raise NotImplementedError(_TP_TODO)


class _Linear(nn.Module):
    def __init__(self, input_size: int, output_size: int, *,
                 bias: bool = True, world_size: int = 1,
                 params_dtype=torch.float32, device=None):
        super().__init__()
        _tp1(world_size)
        self.weight = nn.Parameter(torch.empty(
            output_size, input_size, dtype=params_dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(output_size, dtype=params_dtype,
                                              device=device))
                     if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """LeCun-normal weight (std ``1/sqrt(fan_in)``, the reference's
        default init family), zero bias."""
        std = self.weight.shape[1] ** -0.5
        with torch.no_grad():
            w = torch.randn(self.weight.shape, generator=generator,
                            dtype=torch.float32) * std
            self.weight.copy_(w)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        y = x @ self.weight.to(x.dtype).T
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class ColumnParallelLinear(_Linear):
    """``Y = X A^T + b``; at tp=1 the whole output dim is local."""

    def __init__(self, input_size: int, output_size: int, *,
                 gather_output: bool = True, **kw):
        del gather_output            # identity at tp=1
        super().__init__(input_size, output_size, **kw)


class RowParallelLinear(_Linear):
    """``Y = X A^T + b``; at tp=1 the whole input dim is local."""

    def __init__(self, input_size: int, output_size: int, *,
                 input_is_parallel: bool = False, **kw):
        del input_is_parallel        # identity at tp=1
        super().__init__(input_size, output_size, **kw)


class VocabParallelEmbedding(nn.Module):
    """Embedding table ``(vocab, dim)``; ids are clipped into the table as
    in the reference's unsharded branch. ``attend`` is the tied LM head
    ``x @ W.T`` in x's dtype."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 world_size: int = 1, params_dtype=torch.float32,
                 device=None):
        super().__init__()
        _tp1(world_size)
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, dtype=params_dtype, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape,
                                          generator=generator) * 0.02)

    def forward(self, input_ids):
        ids = input_ids.long().clamp(0, self.weight.shape[0] - 1)
        return self.weight[ids]

    def attend(self, x):
        return x @ self.weight.to(x.dtype).T
