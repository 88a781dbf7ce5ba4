"""Fused optimizer kernels over the flat parameter buffers: the Hopper
kernels ``csrc/adam.cu``, ``csrc/segment_stats.cu``, ``csrc/lamb.cu``,
``csrc/sgd.cu``, ``csrc/novograd.cu`` and ``csrc/scale.cu`` and their
plain PyTorch twins.

Counterpart of ``apex_tpu/ops/optim_kernels.py`` (``_adam_kernel`` /
``adam_update``, ``_stats_kernel`` / ``segment_stats`` /
``global_grad_norm_and_finite``, ``_lamb_phase1_kernel`` and
``_lamb_phase2_kernel`` / ``lamb_update``, ``_sgd_kernel`` /
``sgd_update``, ``_novograd_kernel`` / ``novograd_update``,
``_scale_kernel`` / ``multi_tensor_scale``). Parameters, gradients and the
moments are fp32 ``(rows, LANE)`` buffers laid out by ``flat_buffer``; one
launch updates every parameter. The hyper-parameters travel as small fp32
tensors on the buffers' device (``adam_hyperparams``,
``lamb_hyperparams``, ``sgd_hyperparams``, ``novograd_hyperparams``), as
the reference's SMEM rows do, so the step count, the grad scale and the
skip flag may be device tensors and no host value is read. Per-tensor
reductions (the gradient norm, LAMB's trust ratios, NovoGrad's second
moments) sum each tensor's contiguous rows in a fixed order on the card.

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
    f = _fp32(device)
    if _is_per_tensor(weight_decay):
        weight_decay = 0.0
    b1, b2 = f(beta1), f(beta2)
    rbc1, rbc2 = _bias_corrections(b1, b2, step, bias_correction, f)
    return torch.stack([b1, b2, f(eps), f(weight_decay), f(lr), rbc1, rbc2,
                        f(1.0 if grad_scale is None else grad_scale),
                        f(0.0 if noop is None else noop)])


def fp32_scalar(a, device=None) -> torch.Tensor:
    """A 0-d fp32 tensor on ``device``: a tensor cast and moved, a number
    written by a fill on the device. ``torch.as_tensor`` of a number on a
    CUDA device copies it from the host, and that copy waits for the
    stream: one host sync per hyper-parameter per step."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.full((), float(a), dtype=torch.float32, device=device)


def _fp32(device):
    return lambda a: fp32_scalar(a, device)


def _bias_corrections(b1, b2, step, bias_correction: bool, f):
    """``(1 / (1 - b1^step), 1 / (1 - b2^step))`` in fp32, or ones."""
    one = f(1.0)
    if not bias_correction:
        return one, one
    t = f(step)
    return one / (one - b1 ** t), one / (one - b2 ** t)


def _is_per_tensor(weight_decay) -> bool:
    return isinstance(weight_decay, torch.Tensor) and weight_decay.ndim > 0


def _check_buffers(g, p, m, v, op="adam_update"):
    for name, t in (("g", g), ("p", p), ("m", m), ("v", v)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.ndim != 2 or t.shape[1] != LANE:
            raise ValueError(f"{op}: {name} must be a float32 (rows, "
                             f"{LANE}) buffer, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.shape != p.shape:
            raise ValueError(f"{op}: {name} {tuple(t.shape)} != p "
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


# --- segment statistics ------------------------------------------------------

#: rows of ``segment_stats``' output, as ``STAT_*`` in the reference
STAT_SUMSQ_A, STAT_SUMSQ_B, STAT_NONFINITE = 0, 1, 2


def _check_seg_rows(seg_rows, rows: int):
    if tuple(seg_rows.shape) != (rows,):
        raise ValueError(f"seg_rows {tuple(seg_rows.shape)} != ({rows},)")


def _sumsq_rows(t: torch.Tensor) -> torch.Tensor:
    """Per-row sums of squares of a fp32 ``(rows, LANE)`` buffer, summed in
    fp64."""
    return (t * t).sum(dim=1, dtype=torch.float64)


def _segment_sum(per_row: torch.Tensor, seg_rows, num_segments: int):
    """``[k, rows]`` per-row values -> fp32 ``[k, num_segments]`` sums,
    taken in fp64: far below fp32's rounding, so the result does not depend
    on the order ``index_add_`` happens to add in."""
    out = torch.zeros(per_row.shape[0], num_segments, dtype=torch.float64,
                      device=per_row.device)
    return out.index_add_(1, seg_rows.to(per_row.device).long(),
                          per_row.double()).float()


def segment_stats_reference(a, seg_rows, num_segments: int, b=None):
    """Plain twin of the stats kernel: fp32 ``[3, num_segments]`` holding,
    per segment, ``sum(a^2)``, ``sum(b^2)`` (0 without ``b``) and the count
    of non-finite entries of ``a``."""
    _check_buffers(None, a, None, b, op="segment_stats")
    _check_seg_rows(seg_rows, a.shape[0])
    sumsq_b = _sumsq_rows(b) if b is not None else torch.zeros(
        a.shape[0], dtype=torch.float64, device=a.device)
    per_row = torch.stack([_sumsq_rows(a), sumsq_b,
                           (~torch.isfinite(a)).sum(dim=1).double()])
    return _segment_sum(per_row, seg_rows, num_segments)


def segment_stats(a, seg_rows, num_segments: int, b=None):
    """Per-segment ``[sumsq(a), sumsq(b), nonfinite(a)]``, fp32 ``[3,
    num_segments]``, in one pass: the kernel on a CUDA tensor, the twin on a
    CPU one. Each segment's rows must be contiguous and in order, as
    ``FlatSpec.segment_rows`` lays them out."""
    if a.device.type == "cpu":
        return segment_stats_reference(a, seg_rows, num_segments, b)
    _check_buffers(None, a, None, b, op="segment_stats")
    _check_seg_rows(seg_rows, a.shape[0])
    rows = a.shape[0]
    seg = seg_rows.to(device=a.device, dtype=torch.int32).contiguous()
    part = torch.empty(3 * rows, dtype=torch.float32, device=a.device)
    out = torch.empty(3, num_segments, dtype=torch.float32, device=a.device)
    _build.check_cuda(*[t for t in (a, b, seg) if t is not None])
    P, I = _build.P, _build.I
    _build.launch("segment_stats", "apex_segment_stats",
                  (P, P, P, P, P, I, I, P), a.data_ptr(),
                  b.data_ptr() if b is not None else None, seg.data_ptr(),
                  part.data_ptr(), out.data_ptr(), rows, num_segments,
                  _build.stream_of(a))
    return out


def global_grad_norm_and_finite(g_flat, seg_rows, num_segments: int):
    """``(norm, finite, stats)``: the global L2 norm of the flat gradient
    buffer, a 0-d bool that no entry is inf or NaN, and the per-segment
    stats, from one stats pass; all on the buffer's device, no host read."""
    stats = segment_stats(g_flat, seg_rows, num_segments)
    return (torch.sqrt(stats[STAT_SUMSQ_A].sum()),
            stats[STAT_NONFINITE].sum() == 0.0, stats)


# --- LAMB --------------------------------------------------------------------

#: layout of LAMB's phase-1 row, as ``_LAMB_HP`` in the reference
LAMB_HP = ("beta1", "beta2", "eps", "beta3", "rbc1", "rbc2", "grad_scale",
           "noop", "unused")


def lamb_hyperparams(*, beta1, beta2, eps, step, grad_scale=None, noop=None,
                     bias_correction=True, grad_averaging=True,
                     device=None) -> torch.Tensor:
    """The ``(9,)`` fp32 row ``LAMB_HP`` on ``device``, in fp32 as the
    reference computes it: ``beta3 = 1 - beta1`` with grad averaging, else
    1; ``rbc = 1 / (1 - beta^step)`` with bias correction, else 1."""
    f = _fp32(device)
    b1, b2 = f(beta1), f(beta2)
    rbc1, rbc2 = _bias_corrections(b1, b2, step, bias_correction, f)
    beta3 = 1.0 - b1 if grad_averaging else f(1.0)
    return torch.stack([b1, b2, f(eps), beta3, rbc1, rbc2,
                        f(1.0 if grad_scale is None else grad_scale),
                        f(0.0 if noop is None else noop), f(0.0)])


def lamb_phase1_reference(hp, g, p, m, v, seg_rows, wd_seg):
    """Plain twin of phase 1: ``(u, m, v, stats)`` with ``stats`` fp32
    ``[2, num_segments]`` = per segment ``||p||^2`` and ``||u||^2``.
    ``wd_seg`` is the per-segment decay vector."""
    b1, b2, eps, beta3, rbc1, rbc2, gs, noop, _ = hp.unbind()
    wd = wd_seg.float()[seg_rows.long()][:, None]
    grad = g * gs
    m_new = b1 * m + beta3 * grad
    v_new = b2 * v + (1.0 - b2) * grad * grad
    u = (m_new * rbc1) / (torch.sqrt(v_new * rbc2) + eps) + wd * p
    skip = noop > 0.0
    u = torch.where(skip, 0.0, u)
    per_row = torch.stack([_sumsq_rows(p), _sumsq_rows(u)])
    return (u, torch.where(skip, m, m_new), torch.where(skip, v, v_new),
            _segment_sum(per_row, seg_rows, wd_seg.shape[0]))


def lamb_phase1(hp, g, p, m, v, seg_rows, wd_seg):
    """Phase 1, IN PLACE on ``m`` and ``v``: returns ``(u, m, v, stats)``;
    the kernel on a CUDA tensor, the twin on a CPU one."""
    _check_buffers(g, p, m, v, op="lamb_update")
    _check_seg_rows(seg_rows, p.shape[0])
    if p.device.type == "cpu":
        u, m_new, v_new, stats = lamb_phase1_reference(hp, g, p, m, v,
                                                       seg_rows, wd_seg)
        m.copy_(m_new)
        v.copy_(v_new)
        return u, m, v, stats
    rows, segments = p.shape[0], wd_seg.shape[0]
    seg = seg_rows.to(device=p.device, dtype=torch.int32).contiguous()
    wd = wd_seg.to(device=p.device, dtype=torch.float32).contiguous()
    u = torch.empty_like(p)
    part = torch.empty(2 * rows, dtype=torch.float32, device=p.device)
    stats = torch.empty(2, segments, dtype=torch.float32, device=p.device)
    _build.check_cuda(hp, g, p, m, v, seg, wd)
    P, I = _build.P, _build.I
    _build.launch("lamb_phase1", "apex_lamb_phase1",
                  (P,) * 10 + (I, I, P), hp.data_ptr(), g.data_ptr(),
                  p.data_ptr(), m.data_ptr(), v.data_ptr(), u.data_ptr(),
                  seg.data_ptr(), wd.data_ptr(), part.data_ptr(),
                  stats.data_ptr(), rows, segments, _build.stream_of(p))
    return u, m, v, stats


def lamb_trust_ratio(stats, wd_seg, use_nvlamb: bool = False):
    """Per-segment trust ratio from phase 1's stats, as the reference:
    ``||p|| / ||u||`` where both are positive, else 1; without
    ``use_nvlamb`` only tensors with weight decay take it (the rest 1).
    A few torch ops on a ``(num_segments,)`` vector, on its device."""
    p_norm, u_norm = torch.sqrt(stats[0]), torch.sqrt(stats[1])
    ratio = torch.where((p_norm > 0.0) & (u_norm > 0.0),
                        p_norm / torch.clamp(u_norm, min=1e-30), 1.0)
    if not use_nvlamb:
        ratio = torch.where(wd_seg.to(ratio.device) > 0.0, ratio, 1.0)
    return ratio


def lamb_phase2_reference(hp2, u, p, ratio, seg_rows):
    """Plain twin of phase 2: ``p - lr * ratio[seg] * u``, or ``p`` itself
    under ``noop``. ``hp2`` is ``[lr, noop]``."""
    lr, noop = hp2.unbind()
    step = lr * ratio.float()[seg_rows.long()][:, None]
    return torch.where(noop > 0.0, p, p - step * u)


def lamb_phase2(hp2, u, p, ratio, seg_rows):
    """Phase 2, IN PLACE on ``p`` (returned): the kernel on a CUDA tensor,
    the twin on a CPU one."""
    _check_buffers(u, p, None, None, op="lamb_update")
    if p.device.type == "cpu":
        return p.copy_(lamb_phase2_reference(hp2, u, p, ratio, seg_rows))
    seg = seg_rows.to(device=p.device, dtype=torch.int32).contiguous()
    ratio = ratio.to(device=p.device, dtype=torch.float32).contiguous()
    _build.check_cuda(hp2, u, p, ratio, seg)
    P, I = _build.P, _build.I
    _build.launch("lamb_phase2", "apex_lamb_phase2", (P,) * 5 + (I, P),
                  hp2.data_ptr(), u.data_ptr(), p.data_ptr(),
                  ratio.data_ptr(), seg.data_ptr(), p.shape[0],
                  _build.stream_of(p))
    return p


def lamb_update(g, p, m, v, seg_rows, num_segments: int, *, beta1, beta2,
                eps, weight_decay, lr, step, grad_scale=None, noop=None,
                bias_correction=True, grad_averaging=True, use_nvlamb=False):
    """One fused LAMB step over the flat buffers, IN PLACE on ``p``, ``m``
    and ``v`` (returned): phase 1 (direction and per-tensor norms), the
    trust ratio, phase 2 (apply), as the two stages of the reference.
    ``weight_decay`` is a scalar or a ``(num_segments,)`` per-tensor vector;
    ``noop > 0`` leaves all three bit-identical."""
    device = p.device
    hp1 = lamb_hyperparams(beta1=beta1, beta2=beta2, eps=eps, step=step,
                           grad_scale=grad_scale, noop=noop,
                           bias_correction=bias_correction,
                           grad_averaging=grad_averaging, device=device)
    if _is_per_tensor(weight_decay):
        wd_seg = weight_decay.to(device=device, dtype=torch.float32)
    else:
        wd_seg = torch.full((num_segments,), float(weight_decay),
                            dtype=torch.float32, device=device)
    if wd_seg.shape != (num_segments,):
        raise ValueError(f"weight_decay {tuple(wd_seg.shape)} != "
                         f"({num_segments},)")
    u, m, v, stats = lamb_phase1(hp1, g, p, m, v, seg_rows, wd_seg)
    ratio = lamb_trust_ratio(stats, wd_seg, use_nvlamb)
    hp2 = torch.stack([fp32_scalar(lr, device), hp1[7]])
    lamb_phase2(hp2, u, p, ratio, seg_rows)
    return p, m, v


# --- SGD ---------------------------------------------------------------------

#: layout of the SGD row, as ``_SGD_HP`` in the reference (no grad scale:
#: the reference's kernel has no slot for one)
SGD_HP = ("lr", "momentum", "dampening", "weight_decay", "nesterov", "noop")


def sgd_hyperparams(*, lr, momentum=0.0, dampening=0.0, weight_decay=0.0,
                    nesterov=False, noop=None, step=None,
                    device=None) -> torch.Tensor:
    """The ``(6,)`` fp32 row ``SGD_HP`` on ``device``. ``step`` (1-based)
    applies the reference's first-use rule: dampening 0 at ``step <= 1``,
    so the momentum buffer starts as the raw gradient."""
    f = _fp32(device)
    damp = f(dampening)
    if step is not None:
        damp = torch.where(f(step) <= 1.0, f(0.0), damp)
    return torch.stack([f(lr), f(momentum), damp, f(weight_decay),
                        f(1.0 if nesterov else 0.0),
                        f(0.0 if noop is None else noop)])


def _uses_momentum(momentum) -> bool:
    """Static, as the reference's ``use_momentum``: only a literal 0 turns
    the momentum buffer off (a tensor always keeps it)."""
    return not (isinstance(momentum, (int, float)) and momentum == 0.0)


def sgd_update_reference(g, p, m, *, lr, momentum=0.0, dampening=0.0,
                         weight_decay=0.0, nesterov=False, noop=None,
                         step=None):
    """Plain twin of the SGD kernel: returns new ``(p, m)``.
    ``g += wd * p``; with momentum ``m = mu m + (1 - damp) g`` and the
    direction ``nesterov (g + mu m) + (1 - nesterov) m`` (the reference's
    blend, computed whatever the flag); without, ``m`` stays and the
    direction is ``g``. ``noop > 0`` returns the inputs' values."""
    _check_buffers(g, p, m, None, op="sgd_update")
    hp = sgd_hyperparams(lr=lr, momentum=momentum, dampening=dampening,
                         weight_decay=weight_decay, nesterov=nesterov,
                         noop=noop, step=step, device=p.device)
    lr_, mu, damp, wd, nest, skip = hp.unbind()
    grad = g + wd * p
    if _uses_momentum(momentum):
        m_new = mu * m + (1.0 - damp) * grad
        d = nest * (grad + mu * m_new) + (1.0 - nest) * m_new
    else:
        m_new, d = m, grad
    noop_ = skip > 0.0
    return torch.where(noop_, p, p - lr_ * d), torch.where(noop_, m, m_new)


def sgd_update(g, p, m, *, lr, momentum=0.0, dampening=0.0,
               weight_decay=0.0, nesterov=False, noop=None, step=None):
    """One SGD step over the flat buffers, IN PLACE on ``p`` and ``m``
    (returned): the kernel on a CUDA tensor, the twin on a CPU one."""
    kw = dict(lr=lr, momentum=momentum, dampening=dampening,
              weight_decay=weight_decay, nesterov=nesterov, noop=noop,
              step=step)
    if p.device.type == "cpu":
        for buf, new in zip((p, m), sgd_update_reference(g, p, m, **kw)):
            buf.copy_(new)
        return p, m
    _check_buffers(g, p, m, None, op="sgd_update")
    hp = sgd_hyperparams(**kw, device=p.device)
    _build.check_cuda(hp, g, p, m)
    P, I = _build.P, _build.I
    _build.launch("sgd", "apex_sgd", (P, P, P, P, I, I, P), hp.data_ptr(),
                  g.data_ptr(), p.data_ptr(), m.data_ptr(), p.shape[0],
                  int(_uses_momentum(momentum)), _build.stream_of(p))
    return p, m


# --- NovoGrad ----------------------------------------------------------------

#: layout of the NovoGrad row, as ``_NVG_HP`` in the reference (eps rides
#: in ``vden`` and is unused by the kernel)
NOVOGRAD_HP = ("beta1", "beta3", "eps", "weight_decay", "lr", "grad_scale",
               "noop")


def novograd_hyperparams(*, beta1, eps, weight_decay, lr, grad_scale=None,
                         noop=None, grad_averaging=True,
                         device=None) -> torch.Tensor:
    """The ``(7,)`` fp32 row ``NOVOGRAD_HP`` on ``device``: ``beta3 = 1 -
    beta1`` with grad averaging, else 1."""
    f = _fp32(device)
    b1 = f(beta1)
    beta3 = 1.0 - b1 if grad_averaging else f(1.0)
    return torch.stack([b1, beta3, f(eps), f(weight_decay), f(lr),
                        f(1.0 if grad_scale is None else grad_scale),
                        f(0.0 if noop is None else noop)])


def novograd_second_moment(g_sumsq, v_per_tensor, *, beta2, eps, step,
                           grad_scale=None, init_zero=False):
    """``(v_new, vden)`` per tensor from the per-tensor ``sum(g^2)``: the
    reference's first-step rule (``v_1 = |g|^2``, or ``(1 - b2) |g|^2``
    with ``init_zero``), then the EMA; ``vden = sqrt(v) + eps``. The grad
    scale enters squared, as in the reference."""
    f = _fp32(v_per_tensor.device)
    gs = f(1.0 if grad_scale is None else grad_scale)
    g_sumsq = g_sumsq * gs * gs
    b2 = f(beta2)
    first = (1.0 - b2) * g_sumsq if init_zero else g_sumsq
    v_new = torch.where(f(step) <= 1.0, first,
                        b2 * v_per_tensor + (1.0 - b2) * g_sumsq)
    return v_new, torch.sqrt(v_new) + f(eps)


def novograd_apply_reference(hp, g, p, m, vden, seg_rows):
    """Plain twin of the NovoGrad kernel: new ``(p, m)`` from the row
    ``NOVOGRAD_HP`` and the per-tensor ``vden`` read through
    ``seg_rows``."""
    b1, beta3, _, wd, lr, gs, noop = hp.unbind()
    den = vden.float()[seg_rows.long()][:, None]
    gn = (g * gs) / den + wd * p
    m_new = b1 * m + beta3 * gn
    skip = noop > 0.0
    return torch.where(skip, p, p - lr * m_new), torch.where(skip, m, m_new)


def novograd_apply(hp, g, p, m, vden, seg_rows):
    """The NovoGrad kernel, IN PLACE on ``p`` and ``m`` (returned); the
    twin on a CPU tensor."""
    _check_buffers(g, p, m, None, op="novograd_update")
    _check_seg_rows(seg_rows, p.shape[0])
    if p.device.type == "cpu":
        for buf, new in zip((p, m), novograd_apply_reference(
                hp, g, p, m, vden, seg_rows)):
            buf.copy_(new)
        return p, m
    seg = seg_rows.to(device=p.device, dtype=torch.int32).contiguous()
    vden = vden.to(device=p.device, dtype=torch.float32).contiguous()
    _build.check_cuda(hp, g, p, m, vden, seg)
    P, I = _build.P, _build.I
    _build.launch("novograd", "apex_novograd", (P,) * 6 + (I, P),
                  hp.data_ptr(), g.data_ptr(), p.data_ptr(), m.data_ptr(),
                  vden.data_ptr(), seg.data_ptr(), p.shape[0],
                  _build.stream_of(p))
    return p, m


def _novograd(stats_fn, apply_fn, g, p, m, v_per_tensor, seg_rows,
              num_segments, *, beta1, beta2, eps, weight_decay, lr, step,
              grad_scale, noop, grad_averaging, init_zero):
    if tuple(v_per_tensor.shape) != (num_segments,):
        raise ValueError(f"v_per_tensor {tuple(v_per_tensor.shape)} != "
                         f"({num_segments},)")
    stats = stats_fn(g, seg_rows, num_segments)
    v_new, vden = novograd_second_moment(
        stats[STAT_SUMSQ_A], v_per_tensor, beta2=beta2, eps=eps, step=step,
        grad_scale=grad_scale, init_zero=init_zero)
    hp = novograd_hyperparams(beta1=beta1, eps=eps, weight_decay=weight_decay,
                              lr=lr, grad_scale=grad_scale, noop=noop,
                              grad_averaging=grad_averaging,
                              device=p.device)
    p_new, m_new = apply_fn(hp, g, p, m, vden, seg_rows)
    return p_new, m_new, torch.where(hp[6] > 0.0, v_per_tensor, v_new)


def novograd_update_reference(g, p, m, v_per_tensor, seg_rows,
                              num_segments: int, *, beta1, beta2, eps,
                              weight_decay, lr, step, grad_scale=None,
                              noop=None, grad_averaging=True,
                              init_zero=False):
    """Plain twin of the whole NovoGrad step: returns new ``(p, m,
    v_per_tensor)``; the per-tensor second moment keeps its value on
    ``noop``."""
    return _novograd(segment_stats_reference, novograd_apply_reference, g, p,
                     m, v_per_tensor, seg_rows, num_segments, beta1=beta1,
                     beta2=beta2, eps=eps, weight_decay=weight_decay, lr=lr,
                     step=step, grad_scale=grad_scale, noop=noop,
                     grad_averaging=grad_averaging, init_zero=init_zero)


def novograd_update(g, p, m, v_per_tensor, seg_rows, num_segments: int, *,
                    beta1, beta2, eps, weight_decay, lr, step,
                    grad_scale=None, noop=None, grad_averaging=True,
                    init_zero=False):
    """One fused NovoGrad step, IN PLACE on ``p``, ``m`` and the
    ``(num_segments,)`` ``v_per_tensor`` (returned): the per-tensor
    ``sum(g^2)`` from the stats kernel, the second moment on the device,
    then the update kernel; the twins on a CPU tensor."""
    p, m, v = _novograd(segment_stats, novograd_apply, g, p, m, v_per_tensor,
                        seg_rows, num_segments, beta1=beta1, beta2=beta2,
                        eps=eps, weight_decay=weight_decay, lr=lr, step=step,
                        grad_scale=grad_scale, noop=noop,
                        grad_averaging=grad_averaging, init_zero=init_zero)
    v_per_tensor.copy_(v)
    return p, m, v_per_tensor


# --- scale -------------------------------------------------------------------

def _check_scale_input(x):
    if x.dtype not in _build.COMPUTE_DTYPES or x.ndim != 2 \
            or x.shape[1] != LANE:
        raise ValueError(f"multi_tensor_scale: x must be a float32 or "
                         f"bfloat16 (rows, {LANE}) buffer, got {x.dtype} "
                         f"{tuple(x.shape)}")


def multi_tensor_scale_reference(x, scale):
    """Plain twin of the scale kernel: ``float32(x) * scale``."""
    _check_scale_input(x)
    return x.float() * fp32_scalar(scale, x.device)


def multi_tensor_scale(x, scale):
    """``y = float32(x) * scale`` over a flat ``(rows, LANE)`` buffer of
    fp32 or bf16, one launch, into a new fp32 buffer: the kernel on a CUDA
    tensor, the twin on a CPU one. ``scale`` may be a number or a 0-d
    device tensor (read on the device)."""
    if x.device.type == "cpu":
        return multi_tensor_scale_reference(x, scale)
    _check_scale_input(x)
    s = fp32_scalar(scale, x.device).reshape(1).contiguous()
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _build.check_cuda(x, s, y)
    P, I = _build.P, _build.I
    _build.launch("multi_tensor_scale", "apex_scale", (P, P, P, I, I, P),
                  s.data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[0],
                  _build.dtype_code(x), _build.stream_of(x))
    return y
