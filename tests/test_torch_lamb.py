"""Port parity: apex_tpu_torch's segment stats, LAMB twins and FusedLAMB vs
apex_tpu.

The same numpy flat buffers go through ``apex_tpu.ops.optim_kernels``
(``segment_stats``, ``global_grad_norm_and_finite`` and ``lamb_update``,
their Pallas kernels in interpret mode) and the port's twins: sums of
squares within rtol 1e-5 (the reference's fp32 sums against the twin's
fp64 ones), non-finite counts
exact, LAMB's p/m/v within atol = rtol = 1e-6 over scalar and per-tensor
decay, ``grad_averaging``, ``use_nvlamb`` and bias correction, and a
``noop`` step bit-identical. Then ``FusedLAMB`` against the JAX optimizer
over several steps of the same gradients, with gradient clipping and an
automatic skip on a non-finite gradient followed by a step: parameters per
name within atol 1e-6 / rtol 1e-5, and the step count, which counts the
skipped step as the reference does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import optim_kernels as jax_optim
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu_torch.ops import flat_buffer
from apex_tpu_torch.ops.optim_kernels import (STAT_NONFINITE,
                                              global_grad_norm_and_finite,
                                              lamb_hyperparams, lamb_update,
                                              segment_stats,
                                              segment_stats_reference)
from apex_tpu_torch.optimizers import FusedLAMB

LANE = flat_buffer.LANE
SEG_COUNTS = (5, 11, 8, 1)          # rows of each of four tensors
ROWS = sum(SEG_COUNTS)


def _seg_rows():
    return np.repeat(np.arange(len(SEG_COUNTS), dtype=np.int32), SEG_COUNTS)


def _buffers(seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((ROWS, LANE)).astype(np.float32)
    p = rng.standard_normal((ROWS, LANE)).astype(np.float32)
    m = (rng.standard_normal((ROWS, LANE)) * 0.1).astype(np.float32)
    v = (rng.random((ROWS, LANE)) * 0.01).astype(np.float32)
    return g, p, m, v


@pytest.mark.parametrize("with_b", [False, True])
def test_segment_stats_match_jax_with_inf_and_nan(with_b):
    """Sums of squares per segment against the reference on clean buffers;
    then with an inf and a NaN in A, the non-finite counts exactly. There
    the reference's one-hot product spreads the NaN into every segment's
    sum (inf * 0); the port keeps each sum to its own segment. Both give a
    non-finite total, which is what the gradient norm reads."""
    a, b, _, _ = _buffers(seed=1)
    seg = _seg_rows()
    s = len(SEG_COUNTS)

    def both(a_):
        want = np.asarray(jax_optim.segment_stats(
            jnp.asarray(a_), jnp.asarray(seg), s,
            jnp.asarray(b) if with_b else None))[:3, :s]
        got = segment_stats(torch.from_numpy(a_), torch.from_numpy(seg), s,
                            torch.from_numpy(b) if with_b else None).numpy()
        return got, want

    got, want = both(a)
    assert got.shape == (3, s)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got[1] > 0).all() == with_b
    a[0, 3] = np.inf
    a[7, 10] = np.nan
    a[7, 11] = -np.inf
    got, want = both(a)
    np.testing.assert_array_equal(got[STAT_NONFINITE], want[STAT_NONFINITE])
    np.testing.assert_array_equal(got[STAT_NONFINITE], [1, 2, 0, 0])
    assert np.isinf(got[0, 0]) and np.isnan(got[0, 1])
    assert not np.isfinite(got[0].sum()) and not np.isfinite(want[0].sum())
    np.testing.assert_allclose(got[0, 2:], segment_stats_reference(
        torch.from_numpy(a[5:]), torch.from_numpy(seg[5:] - 1), 3)[0, 1:],
        rtol=1e-6)


def test_global_grad_norm_and_finite_match_jax():
    g = _buffers(seed=2)[0]
    seg = _seg_rows()
    jn, jf, _ = jax_optim.global_grad_norm_and_finite(
        jnp.asarray(g), jnp.asarray(seg), len(SEG_COUNTS))
    tn, tf, stats = global_grad_norm_and_finite(
        torch.from_numpy(g), torch.from_numpy(seg), len(SEG_COUNTS))
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    assert bool(tf) and bool(jf)
    torch.testing.assert_close(stats, segment_stats_reference(
        torch.from_numpy(g), torch.from_numpy(seg), len(SEG_COUNTS)))
    g[5, 5] = np.nan
    assert not bool(global_grad_norm_and_finite(
        torch.from_numpy(g), torch.from_numpy(seg), len(SEG_COUNTS))[1])


@pytest.mark.parametrize("noop", [0.0, 1.0])
@pytest.mark.parametrize("per_tensor", [False, True])
@pytest.mark.parametrize("grad_averaging,use_nvlamb,bias_correction", [
    (True, False, True), (False, True, True), (True, True, False)])
def test_lamb_update_matches_jax(grad_averaging, use_nvlamb, bias_correction,
                                 per_tensor, noop):
    g, p, m, v = _buffers(seed=3 + int(per_tensor))
    seg = _seg_rows()
    s = len(SEG_COUNTS)
    wd = np.asarray([0.0, 0.01, 0.1, 0.0], np.float32) if per_tensor \
        else 0.01
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, lr=1e-2, step=3,
              grad_scale=0.5, noop=noop, bias_correction=bias_correction,
              grad_averaging=grad_averaging, use_nvlamb=use_nvlamb)
    jp, jm, jv = jax_optim.lamb_update(
        *(jnp.asarray(a) for a in (g, p, m, v)), jnp.asarray(seg), s,
        weight_decay=jnp.asarray(wd) if per_tensor else wd, **kw)
    bufs = [torch.from_numpy(a.copy()) for a in (p, m, v)]
    got = lamb_update(torch.from_numpy(g), *bufs, torch.from_numpy(seg), s,
                      weight_decay=torch.from_numpy(wd) if per_tensor
                      else wd, **kw)
    assert [t.data_ptr() for t in got] == [t.data_ptr() for t in bufs]
    for t, want, old in zip(got, (jp, jm, jv), (p, m, v)):
        if noop:
            np.testing.assert_array_equal(t.numpy(), old)
            np.testing.assert_array_equal(np.asarray(want), old)
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-6)


def test_lamb_hyperparams_row():
    row = lamb_hyperparams(beta1=0.9, beta2=0.99, eps=1e-6,
                           step=torch.tensor(2), grad_averaging=False)
    assert row.shape == (9,) and row.dtype == torch.float32
    assert row[3].item() == 1.0
    np.testing.assert_allclose(row[4].item(), 1 / (1 - 0.9 ** 2), rtol=1e-6)
    row = lamb_hyperparams(beta1=0.9, beta2=0.99, eps=1e-6, step=1,
                           bias_correction=False, noop=1.0)
    assert row[4].item() == row[5].item() == 1.0 and row[7].item() == 1.0
    np.testing.assert_allclose(row[3].item(), 0.1, rtol=1e-6)


# --- FusedLAMB --------------------------------------------------------------

SHAPES = {"dense_weight": (40, 64), "dense_bias": (64,),
          "out_weight": (64, 100), "out_norm_weight": (100,)}
STEPS = 6
INF_STEP = 3          # this step's gradient holds an inf: LAMB skips itself


def _no_decay(name):
    return "bias" in name or "norm" in name


def _grads(step):
    rng = np.random.default_rng(100 + step)
    g = {n: (rng.standard_normal(s) * 0.5).astype(np.float32)
         for n, s in SHAPES.items()}
    if step == INF_STEP:
        g["out_weight"][3, 7] = np.inf
    return g


@pytest.mark.parametrize("max_grad_norm", [1.0, 0.0])
def test_fused_lamb_matches_the_jax_optimizer(max_grad_norm):
    """Gradient norms run ~25, so ``max_grad_norm=1.0`` clips every step;
    0 turns clipping off. Step INF_STEP skips itself but counts."""
    rng = np.random.default_rng(7)
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()}
    kw = dict(lr=1e-2, weight_decay=0.01, max_grad_norm=max_grad_norm,
              exclude_from_weight_decay=_no_decay)
    jopt = JaxFusedLAMB({n: jnp.asarray(a) for n, a in params.items()}, **kw)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(a.copy()))
               for n, a in params.items()}
    opt = FusedLAMB(list(tparams.items()), **kw)
    for step in range(1, STEPS + 1):
        g = _grads(step)
        jnew = jopt.step({n: jnp.asarray(a) for n, a in g.items()})
        opt.zero_grad()
        for n, p in tparams.items():
            p.grad.copy_(torch.from_numpy(g[n]))
        before = {n: p.detach().clone() for n, p in tparams.items()}
        opt.step()
        assert int(opt.step_count) == int(jopt.step_count) == step
        for n, p in tparams.items():
            if step == INF_STEP:
                assert torch.equal(p.detach(), before[n]), n
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jnew[n]), atol=1e-6,
                                       rtol=1e-5, err_msg=f"{step} {n}")
    # the moments carried across by name: the step after the skip used
    # state the skip left untouched
    for buf in ("m", "v"):
        got = flat_buffer.unflatten(opt.state[buf], opt.spec)
        want = jax_optim_state(jopt, buf)
        for n in SHAPES:
            np.testing.assert_allclose(got[n].numpy(), want[n], atol=1e-7,
                                       rtol=1e-5, err_msg=f"{buf} {n}")


def jax_optim_state(jopt, buf):
    from apex_tpu.ops import flat_buffer as jax_flat

    tree = jax_flat.unflatten(jopt.state[buf], jopt.spec)
    return {n: np.asarray(a) for n, a in tree.items()}


def test_explicit_noop_does_not_count_and_knobs_raise():
    p = torch.nn.Parameter(torch.ones(8))
    opt = FusedLAMB([("w", p)], lr=0.1)
    p.grad.fill_(1.0)
    opt.step(noop=1.0)
    assert int(opt.step_count) == 0 and torch.equal(p.detach(),
                                                    torch.ones(8))
    opt.step()
    assert int(opt.step_count) == 1 and not torch.equal(p.detach(),
                                                        torch.ones(8))
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB([("w", torch.nn.Parameter(torch.ones(2)))], amsgrad=True)
    with pytest.raises(NotImplementedError, match="adam_w_mode"):
        FusedLAMB([("w", torch.nn.Parameter(torch.ones(2)))],
                  adam_w_mode=False)
