"""Port parity: apex_tpu_torch's flat buffers, Adam kernel twin and
FusedAdam vs apex_tpu.

The same numpy buffers go through ``apex_tpu.ops.optim_kernels.adam_update``
(its Pallas ``_adam_kernel`` in interpret mode) and the port's
``adam_update_reference`` over every surface of the kernel: decoupled or L2
decay, bias correction on or off, scalar or per-segment decay, and the
``noop`` skip. fp32 tolerance atol = rtol = 1e-6 (the same formula, rounded
in another order); a skipped step is bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flat_buffer as jax_flat
from apex_tpu.ops import optim_kernels as jax_optim
from apex_tpu_torch.ops import flat_buffer
from apex_tpu_torch.ops.optim_kernels import (ADAM_HP, adam_hyperparams,
                                              adam_update,
                                              adam_update_reference)
from apex_tpu_torch.optimizers import FusedAdam

LANE = flat_buffer.LANE
ROWS = 24
SEG_COUNTS = (5, 11, 8)          # rows of each of three tensors


def _buffers(seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((ROWS, LANE)).astype(np.float32)
    p = rng.standard_normal((ROWS, LANE)).astype(np.float32)
    m = (rng.standard_normal((ROWS, LANE)) * 0.1).astype(np.float32)
    v = (rng.random((ROWS, LANE)) * 0.01).astype(np.float32)
    return g, p, m, v


def _seg_rows():
    return np.repeat(np.arange(len(SEG_COUNTS), dtype=np.int32), SEG_COUNTS)


@pytest.mark.parametrize("noop", [0.0, 1.0])
@pytest.mark.parametrize("per_segment", [False, True])
@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("adam_w", [True, False])
def test_adam_twin_matches_jax_kernel(adam_w, bias_correction, per_segment,
                                      noop):
    g, p, m, v = _buffers(seed=int(adam_w) + 2 * int(bias_correction))
    seg = _seg_rows()
    wd = np.asarray([0.0, 0.1, 0.01], np.float32) if per_segment else 0.05
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, lr=1e-3, step=3,
              grad_scale=0.5, noop=noop, adam_w_mode=adam_w,
              bias_correction=bias_correction)
    jp, jm, jv = jax_optim.adam_update(
        *(jnp.asarray(a) for a in (g, p, m, v)),
        weight_decay=jnp.asarray(wd) if per_segment else wd,
        seg_rows=jnp.asarray(seg), num_segments=len(SEG_COUNTS), **kw)
    tp, tm, tv = adam_update_reference(
        *(torch.from_numpy(a) for a in (g, p, m, v)),
        weight_decay=torch.from_numpy(wd) if per_segment else wd,
        seg_rows=torch.from_numpy(seg), **kw)
    for got, want, old in zip((tp, tm, tv), (jp, jm, jv), (p, m, v)):
        if noop:
            np.testing.assert_array_equal(got.numpy(), old)
            np.testing.assert_array_equal(np.asarray(want), old)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-6)


def test_adam_update_is_in_place_on_the_cpu():
    g, p, m, v = (torch.from_numpy(a) for a in _buffers(seed=4))
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0, lr=1e-2,
              step=1)
    want = adam_update_reference(g, p, m, v, **kw)
    ptrs = [t.data_ptr() for t in (p, m, v)]
    out = adam_update(g, p, m, v, **kw)
    assert [t.data_ptr() for t in out] == ptrs
    for got, w in zip((p, m, v), want):
        torch.testing.assert_close(got, w, atol=0, rtol=0)


def test_hyperparams_row_from_numbers_and_tensors():
    row = adam_hyperparams(beta1=0.9, beta2=0.99, eps=1e-8, weight_decay=0.1,
                           lr=1e-3, step=2)
    assert row.shape == (len(ADAM_HP),) and row.dtype == torch.float32
    np.testing.assert_allclose(row[5].item(), 1 / (1 - 0.9 ** 2), rtol=1e-5)
    np.testing.assert_allclose(row[6].item(), 1 / (1 - 0.99 ** 2),
                               rtol=1e-5)
    dev = adam_hyperparams(beta1=0.9, beta2=0.99, eps=1e-8, weight_decay=0.1,
                           lr=1e-3, step=torch.tensor(2),
                           noop=torch.tensor(0.0))
    torch.testing.assert_close(dev, row)
    seg = adam_hyperparams(beta1=0.9, beta2=0.99, eps=1e-8,
                           weight_decay=torch.ones(3), lr=1e-3, step=1,
                           bias_correction=False)
    assert seg[3].item() == 0.0 and seg[5].item() == seg[6].item() == 1.0


def test_per_segment_decay_needs_seg_rows():
    g, p, m, v = (torch.from_numpy(a) for a in _buffers())
    with pytest.raises(ValueError, match="seg_rows"):
        adam_update_reference(g, p, m, v, beta1=0.9, beta2=0.999, eps=1e-8,
                              weight_decay=torch.ones(3), lr=1e-3, step=1)


def test_adam_rejects_non_flat_buffers():
    g, p, m, v = (torch.from_numpy(a) for a in _buffers())
    with pytest.raises(ValueError, match="float32"):
        adam_update(g[:, :512], p, m, v, beta1=0.9, beta2=0.999, eps=1e-8,
                    weight_decay=0.0, lr=1e-3, step=1)


# --- flat buffers ---------------------------------------------------------


def _named_tensors(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 700), "b": (5,), "c": (1024,), "d": (2, 3, 4),
              "e": ()}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def test_flat_layout_matches_jax():
    arrays = _named_tensors()
    jspec = jax_flat.build_spec([jnp.asarray(a) for a in arrays.values()])
    named = [(k, torch.from_numpy(a)) for k, a in arrays.items()]
    spec = flat_buffer.build_spec(named)
    assert spec.names == tuple(arrays)
    for f in ("shapes", "sizes", "row_offsets", "row_counts", "total_rows",
              "num_tensors", "total_elements"):
        assert getattr(spec, f) == getattr(jspec, f), f
    np.testing.assert_array_equal(spec.segment_rows().numpy(),
                                  jspec.segment_rows())
    flat = flat_buffer.flatten(named, spec)
    jflat = jax_flat.flatten([jnp.asarray(a) for a in arrays.values()],
                             jspec)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))


def test_unflatten_round_trips_and_gives_views():
    arrays = {k: torch.from_numpy(a) for k, a in _named_tensors(1).items()}
    spec = flat_buffer.build_spec(arrays.items())
    flat = flat_buffer.flatten(arrays.items(), spec)
    back = flat_buffer.unflatten(flat, spec)
    for k, a in arrays.items():
        torch.testing.assert_close(back[k], a, atol=0, rtol=0)
    back["b"].fill_(7.0)
    assert (flat[spec.row_offsets[1], :5] == 7.0).all()
    assert (flat[spec.row_offsets[1], 5:] == 0.0).all()     # the padding


# --- FusedAdam ------------------------------------------------------------


def _params():
    torch.manual_seed(0)
    return [("w", torch.nn.Parameter(torch.randn(4, 300))),
            ("norm.weight", torch.nn.Parameter(torch.ones(300))),
            ("bias", torch.nn.Parameter(torch.zeros(7)))]


def test_params_and_grads_become_flat_views():
    named = _params()
    before = {n: p.detach().clone() for n, p in named}
    opt = FusedAdam(named, lr=0.1)
    base = opt.master.data_ptr()
    for (n, p), off in zip(named, opt.spec.row_offsets):
        assert p.data_ptr() == base + off * LANE * 4
        torch.testing.assert_close(p.detach(), before[n], atol=0, rtol=0)
        assert p.grad is not None and p.grad.data_ptr() == (
            opt.grads.data_ptr() + off * LANE * 4)
    loss = sum((p * p).sum() for _, p in named)
    loss.backward()
    assert named[0][1].grad.data_ptr() == opt.grads.data_ptr()
    torch.testing.assert_close(named[0][1].grad, 2 * before["w"])


def test_step_matches_the_twin_and_copies_foreign_grads():
    named = _params()
    opt = FusedAdam(named, lr=0.1, weight_decay=0.01,
                    exclude_from_weight_decay=lambda n: "norm" in n
                    or n.endswith("bias"))
    np.testing.assert_array_equal(opt.wd_per_segment.numpy(),
                                  np.asarray([0.01, 0.0, 0.0], np.float32))
    g = {n: torch.randn(p.shape) for n, p in named}
    for n, p in named:
        p.grad = g[n].clone()           # not the flat view: copied in
    p0 = opt.master.clone()
    want = adam_update_reference(
        flat_buffer.flatten(g.items(), opt.spec), p0, torch.zeros_like(p0),
        torch.zeros_like(p0), beta1=0.9, beta2=0.999, eps=1e-8,
        weight_decay=opt.wd_per_segment, lr=0.1, step=1,
        seg_rows=opt.seg_rows)
    opt.step()
    torch.testing.assert_close(opt.master, want[0], atol=1e-7, rtol=1e-6)
    torch.testing.assert_close(opt.state["v"], want[2], atol=1e-9, rtol=1e-6)
    assert int(opt.step_count) == 1
    for (_, p), view in zip(named, opt._grad_views):
        assert p.grad.data_ptr() == view.data_ptr()


def test_decay_follows_the_group_after_construction():
    named = _params()
    opt = FusedAdam(named, lr=0.1, weight_decay=0.01,
                    exclude_from_weight_decay=lambda n: "norm" in n
                    or n.endswith("bias"))
    opt.param_groups[0]["weight_decay"] = 0.5      # as a scheduler would
    np.testing.assert_array_equal(opt.wd_per_segment.numpy(),
                                  np.asarray([0.5, 0.0, 0.0], np.float32))
    for _, p in named:
        p.grad.normal_()
    p0 = opt.master.clone()
    want = adam_update_reference(
        opt.grads.clone(), p0, torch.zeros_like(p0), torch.zeros_like(p0),
        beta1=0.9, beta2=0.999, eps=1e-8,
        weight_decay=torch.tensor([0.5, 0.0, 0.0]), lr=0.1, step=1,
        seg_rows=opt.seg_rows)
    opt.step()
    torch.testing.assert_close(opt.master, want[0], atol=1e-7, rtol=1e-6)
    sd = opt.state_dict()
    sd["defaults"]["weight_decay"] = 0.25
    opt.load_state_dict(sd)
    np.testing.assert_array_equal(opt.wd_per_segment.numpy(),
                                  np.asarray([0.25, 0.0, 0.0], np.float32))


def test_skipped_step_keeps_state_and_count():
    named = _params()
    opt = FusedAdam(named, lr=0.1)
    for _, p in named:
        p.grad.normal_()
    opt.step()
    snap = opt.state_dict()
    for _, p in named:
        p.grad.fill_(float("inf"))
    opt.step(noop=torch.tensor(1.0))
    assert int(opt.step_count) == 1
    assert torch.equal(opt.master, snap["master"])
    for k in ("m", "v"):
        assert torch.equal(opt.state[k], snap["state"][k])
    opt.load_state_dict(snap)
    assert int(opt.step_count) == 1


def test_missing_grad_counts_as_zero_and_zero_grad_reattaches():
    named = _params()
    opt = FusedAdam(named, lr=0.1)
    for _, p in named:
        p.grad = None
    opt.step()
    assert torch.equal(opt.state["m"], torch.zeros_like(opt.state["m"]))
    opt.zero_grad(set_to_none=True)
    assert all(p.grad is not None and (p.grad == 0).all() for _, p in named)


def test_grads_present_at_construction_are_kept():
    named = _params()
    for _, p in named:
        p.grad = torch.full_like(p, 2.0)
    opt = FusedAdam(named, lr=0.1)
    assert (opt.grads[:opt.spec.row_offsets[1], :] != 0).any()
    for (_, p), view in zip(named, opt._grad_views):
        assert p.grad.data_ptr() == view.data_ptr() and (p.grad == 2.0).all()


def test_unsupported_fused_adam_options_raise():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(_params(), amsgrad=True)
    opt = FusedAdam(_params())
    with pytest.raises(NotImplementedError, match="item 11: amp/"):
        opt.attach_amp_scaler(object())
    with pytest.raises(TypeError, match="fp32"):
        FusedAdam([("h", torch.nn.Parameter(torch.zeros(3).bfloat16()))])
