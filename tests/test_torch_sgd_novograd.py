"""Port parity: the SGD, NovoGrad and scale kernels' twins, FusedSGD and
FusedNovoGrad against apex_tpu.

The same numpy buffers go through ``apex_tpu.ops.optim_kernels``'
``sgd_update``, ``novograd_update`` and ``multi_tensor_scale`` (their Pallas
kernels in interpret mode) and the port's twins: SGD over momentum 0 and
0.9, dampening, Nesterov, decay, the first step against a later one and
``noop``; NovoGrad over ``init_zero``, ``grad_averaging``, a grad scale
and ``noop``; the scale over fp32 and bf16 buffers. Then three steps of
each optimizer over the same parameters on both sides, the constructors'
errors, and the state-dict round trip. fp32 atol = rtol = 1e-6 (the same
formula, rounded in another order; NovoGrad's per-tensor sums taken in
fp64 here and on the MXU there); a skipped step is bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flat_buffer as jax_flat
from apex_tpu.ops import optim_kernels as jax_optim
from apex_tpu.optimizers import FusedNovoGrad as JaxFusedNovoGrad
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu_torch.ops import flat_buffer
from apex_tpu_torch.ops.optim_kernels import (SGD_HP, multi_tensor_scale,
                                              multi_tensor_scale_reference,
                                              novograd_update,
                                              novograd_update_reference,
                                              sgd_hyperparams, sgd_update,
                                              sgd_update_reference)
from apex_tpu_torch.optimizers import FusedNovoGrad, FusedSGD

LANE = flat_buffer.LANE
ROWS = 12
SEG_COUNTS = (3, 7, 2)
TOL = dict(atol=1e-6, rtol=1e-6)


def _buffers(seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((ROWS, LANE)).astype(np.float32)
    p = rng.standard_normal((ROWS, LANE)).astype(np.float32)
    m = (rng.standard_normal((ROWS, LANE)) * 0.1).astype(np.float32)
    return g, p, m


def _seg_rows():
    return np.repeat(np.arange(len(SEG_COUNTS), dtype=np.int32), SEG_COUNTS)


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


# (momentum, dampening, nesterov, weight_decay, step, noop)
SGD_CASES = [
    (0.9, 0.0, False, 1e-4, 1, 0.0),
    (0.9, 0.0, False, 1e-4, 2, 0.0),
    (0.9, 0.1, False, 0.0, 1, 0.0),
    (0.9, 0.1, False, 1e-4, 3, 0.0),
    (0.9, 0.0, True, 1e-4, 1, 0.0),
    (0.9, 0.0, True, 1e-4, 2, 0.0),
    (0.0, 0.0, False, 1e-4, 2, 0.0),
    (0.0, 0.0, False, 0.0, 1, 0.0),
    (0.9, 0.0, False, 1e-4, 2, 1.0),
    (0.0, 0.0, False, 1e-4, 2, 1.0),
    (0.9, 0.0, True, 0.0, None, 0.0),
]


@pytest.mark.parametrize("momentum,dampening,nesterov,wd,step,noop",
                         SGD_CASES)
def test_sgd_twin_matches_jax_kernel(momentum, dampening, nesterov, wd, step,
                                     noop):
    g, p, m = _buffers()
    kw = dict(lr=0.1, momentum=momentum, dampening=dampening,
              weight_decay=wd, nesterov=nesterov, noop=noop, step=step)
    jp, jm = jax_optim.sgd_update(jnp.asarray(g), jnp.asarray(p),
                                  jnp.asarray(m), **kw)
    tp, tm = sgd_update_reference(*_t(g, p, m), **kw)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    if noop:
        assert np.array_equal(tp.numpy(), p) and np.array_equal(tm.numpy(), m)
    if momentum == 0.0:
        assert np.array_equal(tm.numpy(), m)
    # the in-place wrapper takes the twin on the CPU
    bufs = _t(g, p, m)
    sgd_update(*bufs, **kw)
    assert torch.equal(bufs[1], tp) and torch.equal(bufs[2], tm)


def test_sgd_row_and_first_step_rule():
    hp = sgd_hyperparams(lr=0.1, momentum=0.9, dampening=0.25,
                         weight_decay=1e-4, nesterov=True, noop=1.0, step=1)
    assert len(SGD_HP) == hp.numel() == 6
    assert hp.tolist() == pytest.approx([0.1, 0.9, 0.0, 1e-4, 1.0, 1.0])
    later = sgd_hyperparams(lr=0.1, momentum=0.9, dampening=0.25, step=2)
    assert later[2].item() == 0.25


def test_sgd_nonfinite_gradient_gives_jax_result():
    g, p, m = _buffers(1)
    g[0, :3] = [np.inf, -np.inf, np.nan]
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, nesterov=False,
              step=2)
    jp, jm = jax_optim.sgd_update(jnp.asarray(g), jnp.asarray(p),
                                  jnp.asarray(m), **kw)
    tp, tm = sgd_update_reference(*_t(g, p, m), **kw)
    np.testing.assert_array_equal(np.isnan(tp.numpy()), np.isnan(jp))
    np.testing.assert_array_equal(np.isnan(tm.numpy()), np.isnan(jm))
    fin = np.isfinite(np.asarray(jp))
    np.testing.assert_allclose(tp.numpy()[fin], np.asarray(jp)[fin], **TOL)


# (init_zero, grad_averaging, step, grad_scale, noop)
NVG_CASES = [
    (False, True, 1, None, 0.0),
    (False, True, 2, None, 0.0),
    (True, True, 1, None, 0.0),
    (True, True, 2, 0.5, 0.0),
    (False, False, 2, 0.5, 0.0),
    (False, True, 2, 2.0, 1.0),
]


@pytest.mark.parametrize("init_zero,grad_averaging,step,grad_scale,noop",
                         NVG_CASES)
def test_novograd_twin_matches_jax_kernel(init_zero, grad_averaging, step,
                                          grad_scale, noop):
    g, p, m = _buffers(2)
    seg = _seg_rows()
    v = np.random.default_rng(3).random(len(SEG_COUNTS)).astype(
        np.float32) * 100
    kw = dict(beta1=0.95, beta2=0.98, eps=1e-8, weight_decay=1e-3, lr=0.01,
              step=step, grad_scale=grad_scale, noop=noop,
              grad_averaging=grad_averaging, init_zero=init_zero)
    jp, jm, jv = jax_optim.novograd_update(
        jnp.asarray(g), jnp.asarray(p), jnp.asarray(m), jnp.asarray(v), seg,
        len(SEG_COUNTS), **kw)
    tg, tp, tm, tv = _t(g, p, m, v)
    rp, rm, rv = novograd_update_reference(tg, tp, tm, tv,
                                           torch.from_numpy(seg),
                                           len(SEG_COUNTS), **kw)
    for got, want in ((rp, jp), (rm, jm), (rv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if noop:
        for got, before in ((rp, p), (rm, m), (rv, v)):
            assert np.array_equal(got.numpy(), before)
    # the in-place wrapper takes the twins on the CPU, v included
    novograd_update(tg, tp, tm, tv, torch.from_numpy(seg), len(SEG_COUNTS),
                    **kw)
    assert torch.equal(tp, rp) and torch.equal(tm, rm) and torch.equal(tv, rv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_tensor_scale_matches_jax(dtype):
    x = np.random.default_rng(4).standard_normal((ROWS, LANE)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jax_optim.multi_tensor_scale(jx, 1.0 / 65536.0))
    got = multi_tensor_scale(tx, 1.0 / 65536.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(multi_tensor_scale_reference(tx, torch.tensor(3.0)),
                       tx.float() * 3.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        multi_tensor_scale(torch.zeros(ROWS, 7), 2.0)


# --- the optimizers over the same parameters --------------------------------

SHAPES = {"conv": (4, 3, 3, 3), "bias": (5,), "fc": (7, 300)}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _port_params(params):
    return [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
            for k, v in params.items()]


def _run_both(jax_cls, port_cls, steps=3, **kw):
    params = _params()
    jopt = jax_cls({k: jnp.asarray(v) for k, v in params.items()}, **kw)
    named = _port_params(params)
    opt = port_cls(named, **kw)
    for i in range(steps):
        g = _grads(i)
        jp = jopt.step({k: jnp.asarray(v) for k, v in g.items()})
        for k, p in named:
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in named:
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       **TOL, err_msg=f"{k} step {i}")
    return jopt, opt, named


@pytest.mark.parametrize("kw", [
    dict(lr=0.1, momentum=0.9, weight_decay=1e-4),
    dict(lr=0.05, momentum=0.9, nesterov=True, weight_decay=1e-4),
    dict(lr=0.05, momentum=0.9, dampening=0.1),
    dict(lr=0.1, momentum=0.0, weight_decay=1e-4),
], ids=["resnet", "nesterov", "dampening", "plain"])
def test_fused_sgd_matches_jax_over_three_steps(kw):
    jopt, opt, _ = _run_both(JaxFusedSGD, FusedSGD, **kw)
    want = jax_flat.unflatten(jopt.state["momentum_buffer"], jopt.spec)
    got = flat_buffer.unflatten(opt.state["momentum_buffer"], opt.spec)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)
    assert int(opt.step_count) == int(jopt.step_count) == 3


@pytest.mark.parametrize("kw", [
    dict(lr=0.01, weight_decay=1e-3),
    dict(lr=0.01, betas=(0.9, 0.99), init_zero=True, grad_averaging=False),
], ids=["default", "init_zero"])
def test_fused_novograd_matches_jax_over_three_steps(kw):
    jopt, opt, _ = _run_both(JaxFusedNovoGrad, FusedNovoGrad, **kw)
    # JAX orders its segments by sorted key, the port by the given order
    jv = dict(zip(sorted(SHAPES), np.asarray(jopt.state["v_per_tensor"])))
    for k, v in zip(opt.spec.names, opt.state["v_per_tensor"].numpy()):
        np.testing.assert_allclose(v, jv[k], **TOL, err_msg=k)
    want = jax_flat.unflatten(jopt.state["m"], jopt.spec)
    got = flat_buffer.unflatten(opt.state["m"], opt.spec)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("cls,kw,err", [
    ("sgd", dict(lr=0.1, nesterov=True), ValueError),
    ("sgd", dict(lr=0.1, momentum=0.9, dampening=0.1, nesterov=True),
     ValueError),
    ("sgd", dict(lr=0.1, wd_after_momentum=True), NotImplementedError),
    ("novograd", dict(amsgrad=True), RuntimeError),
    ("novograd", dict(norm_type=1), ValueError),
])
def test_constructor_errors_match_jax(cls, kw, err):
    jax_cls, port_cls = {"sgd": (JaxFusedSGD, FusedSGD),
                         "novograd": (JaxFusedNovoGrad, FusedNovoGrad)}[cls]
    params = _params()
    with pytest.raises(err) as want:
        jax_cls({k: jnp.asarray(v) for k, v in params.items()}, **kw)
    with pytest.raises(err) as got:
        port_cls(_port_params(params), **kw)
    assert str(got.value) == str(want.value)


def test_novograd_ignores_the_knobs_the_reference_ignores():
    a = FusedNovoGrad(_port_params(_params()), lr=0.01)
    b = FusedNovoGrad(_port_params(_params()), lr=0.01,
                      bias_correction=False, reg_inside_moment=True)
    for opt in (a, b):
        for (k, p) in zip(SHAPES, opt.params):
            p.grad = torch.from_numpy(_grads(0)[k])
        opt.step()
    assert torch.equal(a.master, b.master)


@pytest.mark.parametrize("cls,kw", [
    (FusedSGD, dict(lr=0.1, momentum=0.9, weight_decay=1e-4)),
    (FusedNovoGrad, dict(lr=0.01, weight_decay=1e-3)),
], ids=["sgd", "novograd"])
def test_state_dict_round_trip(cls, kw):
    named = _port_params(_params())
    opt = cls(named, **kw)
    for i in range(2):
        for k, p in named:
            p.grad = torch.from_numpy(_grads(i)[k])
        opt.step()
    sd = opt.state_dict()
    assert set(sd["state"]) == set(opt.state)
    if cls is FusedNovoGrad:
        assert sd["state"]["v_per_tensor"].shape == (len(SHAPES),)
    other = cls(_port_params(_params(9)), **kw)
    other.load_state_dict(sd)
    for o in (opt, other):
        for k, p in zip(SHAPES, o.params):
            p.grad = torch.from_numpy(_grads(5)[k])
        o.step()
    assert torch.equal(opt.master, other.master)
    for k in opt.state:
        assert torch.equal(opt.state[k], other.state[k]), k
    assert int(other.step_count) == 3


def test_explicit_noop_skips_without_counting():
    named = _port_params(_params())
    opt = FusedSGD(named, lr=0.1, momentum=0.9)
    for k, p in named:
        p.grad = torch.from_numpy(_grads(0)[k])
    before = opt.master.clone()
    opt.step(noop=1.0)
    assert torch.equal(opt.master, before) and int(opt.step_count) == 0
    assert not opt.state["momentum_buffer"].any()
