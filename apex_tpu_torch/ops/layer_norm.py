"""LayerNorm forward: the Hopper kernel ``csrc/layer_norm_fwd.cu`` and its
plain PyTorch twin.

Counterpart of ``apex_tpu/ops/layer_norm.py`` (``_ln_fwd_kernel``,
``_ln_fwd``, ``layer_norm``), forward only — this port is inference-only.
Semantics: fp32 statistics whatever x's dtype, fp32 weight and bias over an
fp32 or bf16 x (the reference's "mixed" variants), output in x's dtype.

A tensor on the CPU takes the twin; a CUDA tensor always takes the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _build


def layer_norm_fwd_reference(x2d: torch.Tensor, weight=None, bias=None,
                             eps: float = 1e-5):
    """Plain twin of the kernel: ``(y, mean, rstd)`` for a 2-D ``x``, with
    ``mean``/``rstd`` fp32 of shape ``(rows, 1)``."""
    xf = x2d.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd
    if weight is not None:
        y = y * weight.float()
        if bias is not None:
            y = y + bias.float()
    return y.to(x2d.dtype), mean, rstd


def layer_norm_fwd(x2d: torch.Tensor, weight=None, bias=None,
                   eps: float = 1e-5):
    """``(y, mean, rstd)`` for a 2-D ``x``: the kernel on a CUDA tensor, the
    twin on a CPU one."""
    if x2d.device.type == "cpu":
        return layer_norm_fwd_reference(x2d, weight, bias, eps)
    rows, cols = x2d.shape
    x2d = x2d.contiguous()
    w = weight.float().contiguous() if weight is not None else None
    b = bias.float().contiguous() if bias is not None else None
    y = torch.empty_like(x2d)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    _build.check_cuda(*[t for t in (x2d, w, b) if t is not None])
    P, I, F = _build.P, _build.I, _build.F
    _build.launch(
        "layer_norm_fwd", "apex_layer_norm_fwd",
        (P, P, P, P, P, P, I, I, F, I, P),
        x2d.data_ptr(), w.data_ptr() if w is not None else None,
        b.data_ptr() if b is not None else None, y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), rows, cols, float(eps),
        _build.dtype_code(x2d), _build.stream_of(x2d))
    return y, mean, rstd


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5):
    """Fused LayerNorm over the last dimension (forward)."""
    if weight is None and bias is not None:
        raise ValueError("layer_norm: bias requires weight (the reference "
                         "API has no bias-only variant)")
    cols = x.shape[-1]
    y, _, _ = layer_norm_fwd(x.reshape(-1, cols), weight, bias, eps)
    return y.reshape(x.shape)
