"""Fused optimizer update over the flat parameter buffers: the Hopper kernel
``csrc/adam.cu`` and its plain PyTorch twin.

Counterpart of ``apex_tpu/ops/optim_kernels.py`` (``_adam_kernel``,
``adam_update``). Parameters, gradients and the Adam moments are fp32
``(rows, LANE)`` buffers laid out by ``flat_buffer``; one launch updates
every parameter. The hyper-parameters travel as a 9-float tensor on the
buffers' device (``adam_hyperparams``), as the reference's SMEM row does, so
the step count, the grad scale and the skip flag may be device tensors and
no host value is read. The other optimizer kernels of the reference (stats,
SGD, LAMB, NovoGrad, scale) are not ported yet (ROADMAP queue B items
12-17).

A tensor on the CPU takes the twin; a CUDA tensor always takes the kernel.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.flat_buffer import LANE

#: layout of the hyper-parameter row, as ``_ADAM_HP`` in the reference
ADAM_HP = ("beta1", "beta2", "eps", "weight_decay", "lr", "rbc1", "rbc2",
           "grad_scale", "noop")


def adam_hyperparams(*, beta1, beta2, eps, weight_decay, lr, step,
                     grad_scale=None, noop=None, bias_correction=True,
                     device=None) -> torch.Tensor:
    """The ``(9,)`` fp32 row ``ADAM_HP`` on ``device``, computed in fp32 as
    the reference does. Each argument may be a number or a 0-d tensor; a
    per-tensor ``weight_decay`` vector puts 0 in the row (the kernel then
    reads the vector). ``rbc = 1 / (1 - beta^step)`` with bias correction,
    else 1."""
    def f(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    if _is_per_tensor(weight_decay):
        weight_decay = 0.0
    b1, b2 = f(beta1), f(beta2)
    one = f(1.0)
    if bias_correction:
        t = f(step)
        rbc1, rbc2 = one / (one - b1 ** t), one / (one - b2 ** t)
    else:
        rbc1 = rbc2 = one
    return torch.stack([b1, b2, f(eps), f(weight_decay), f(lr), rbc1, rbc2,
                        f(1.0 if grad_scale is None else grad_scale),
                        f(0.0 if noop is None else noop)])


def _is_per_tensor(weight_decay) -> bool:
    return isinstance(weight_decay, torch.Tensor) and weight_decay.ndim > 0


def _check_buffers(g, p, m, v):
    for name, t in (("g", g), ("p", p), ("m", m), ("v", v)):
        if t.dtype != torch.float32 or t.ndim != 2 or t.shape[1] != LANE:
            raise ValueError(f"adam_update: {name} must be a float32 (rows, "
                             f"{LANE}) buffer, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.shape != p.shape:
            raise ValueError(f"adam_update: {name} {tuple(t.shape)} != p "
                             f"{tuple(p.shape)}")


def _segment_rows(weight_decay, seg_rows, rows: int):
    """The int32 row -> tensor map a per-tensor ``weight_decay`` needs, or
    None for a scalar decay."""
    if not _is_per_tensor(weight_decay):
        return None
    if seg_rows is None:
        raise ValueError("per-tensor weight_decay requires seg_rows")
    if tuple(seg_rows.shape) != (rows,):
        raise ValueError(f"seg_rows {tuple(seg_rows.shape)} != ({rows},)")
    return seg_rows


def adam_update_reference(g, p, m, v, *, beta1, beta2, eps, weight_decay, lr,
                          step, grad_scale=None, noop=None, adam_w_mode=True,
                          bias_correction=True, seg_rows=None):
    """Plain twin of the kernel: returns new ``(p, m, v)``. ``weight_decay``
    is a scalar, or a per-tensor vector read through ``seg_rows`` (int32
    row -> tensor index). L2 decay (``adam_w_mode=False``) adds ``wd * p``
    to the scaled gradient; decoupled decay adds it to the update.
    ``noop > 0`` returns the inputs' values unchanged (where-select)."""
    _check_buffers(g, p, m, v)
    hp = adam_hyperparams(beta1=beta1, beta2=beta2, eps=eps,
                          weight_decay=weight_decay, lr=lr, step=step,
                          grad_scale=grad_scale, noop=noop,
                          bias_correction=bias_correction, device=p.device)
    b1, b2, e, wd, lr_, rbc1, rbc2, gs, skip = hp.unbind()
    seg = _segment_rows(weight_decay, seg_rows, p.shape[0])
    if seg is not None:
        wd = weight_decay.float()[seg.long()][:, None]
    grad = g * gs
    if not adam_w_mode:
        grad = grad + wd * p
    m_new = b1 * m + (1.0 - b1) * grad
    v_new = b2 * v + (1.0 - b2) * grad * grad
    update = (m_new * rbc1) / (torch.sqrt(v_new * rbc2) + e)
    if adam_w_mode:
        update = update + wd * p
    noop_ = skip > 0.0
    return (torch.where(noop_, p, p - lr_ * update),
            torch.where(noop_, m, m_new), torch.where(noop_, v, v_new))


def adam_update(g, p, m, v, *, beta1, beta2, eps, weight_decay, lr, step,
                grad_scale=None, noop=None, adam_w_mode=True,
                bias_correction=True, seg_rows=None):
    """One Adam(W) step over the flat buffers, IN PLACE on ``p``, ``m`` and
    ``v`` (returned): the kernel on a CUDA tensor, the twin on a CPU one."""
    kw = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
              lr=lr, step=step, grad_scale=grad_scale, noop=noop,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction,
              seg_rows=seg_rows)
    if p.device.type == "cpu":
        for buf, new in zip((p, m, v),
                            adam_update_reference(g, p, m, v, **kw)):
            buf.copy_(new)
        return p, m, v
    _check_buffers(g, p, m, v)
    hp = adam_hyperparams(beta1=beta1, beta2=beta2, eps=eps,
                          weight_decay=weight_decay, lr=lr, step=step,
                          grad_scale=grad_scale, noop=noop,
                          bias_correction=bias_correction, device=p.device)
    seg = _segment_rows(weight_decay, seg_rows, p.shape[0])
    wd_seg = None
    if seg is not None:
        seg = seg.to(device=p.device, dtype=torch.int32).contiguous()
        wd_seg = weight_decay.to(device=p.device,
                                 dtype=torch.float32).contiguous()
    tensors = [t for t in (hp, g, p, m, v, seg, wd_seg) if t is not None]
    _build.check_cuda(*tensors)
    P, I = _build.P, _build.I
    _build.launch(
        "adam", "apex_adam", (P, P, P, P, P, P, P, I, I, P),
        hp.data_ptr(), g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
        seg.data_ptr() if seg is not None else None,
        wd_seg.data_ptr() if wd_seg is not None else None, p.shape[0],
        int(bool(adam_w_mode)), _build.stream_of(p))
    return p, m, v
