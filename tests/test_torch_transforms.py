"""Port parity: ``apex_tpu_torch.optimizers.transforms`` against
``apex_tpu.optimizers.transforms``.

Each of ``fused_adam``, ``fused_lamb``, ``fused_sgd`` and
``fused_novograd`` runs three updates on both sides from the same numpy
parameters and gradients (the parameters moved by the deltas between
steps): the deltas, the count and the flat state against JAX's (atol =
rtol = 1e-6, as ``tests/test_torch_optim.py``; the JAX kernels in interpret
mode). LAMB also clips (a gradient norm above ``max_grad_norm``) and skips
a non-finite step; a callable learning rate gets the count. The state
handed in is left as it was, and ``params`` is required, as in the
reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import transforms as jt
from apex_tpu_torch.optimizers import transforms as tt

TOL = dict(atol=1e-6, rtol=1e-6)
SHAPES = {"a_weight": (6, 5), "b_bias": (5,), "c_kernel": (3, 1100)}

CASES = {
    "adam": lambda m: m.fused_adam(1e-2, weight_decay=0.01),
    "adam_l2_schedule": lambda m: m.fused_adam(
        lambda c: 1e-2 / c, weight_decay=0.01, adam_w_mode=False),
    "lamb": lambda m: m.fused_lamb(1e-2, max_grad_norm=1.0),
    "lamb_no_clip": lambda m: m.fused_lamb(1e-2, max_grad_norm=0.0,
                                           grad_averaging=False),
    "sgd": lambda m: m.fused_sgd(0.1, momentum=0.9, dampening=0.1,
                                 weight_decay=1e-4),
    "sgd_nesterov": lambda m: m.fused_sgd(0.1, momentum=0.9, nesterov=True),
    "novograd": lambda m: m.fused_novograd(1e-2, weight_decay=1e-3),
}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _close(got, want, msg):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                               err_msg=msg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_transform_deltas_and_state_match_jax(case):
    jtx, ttx = CASES[case](jt), CASES[case](tt)
    params = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for i in range(3):
        # step 1 has a large gradient (LAMB clips it), step 2 an inf in
        # LAMB's cases (it skips)
        g = _tree(10 + i, scale=5.0 if i == 1 else 1.0)
        if i == 2 and case.startswith("lamb"):
            g["b_bias"][1] = np.inf
        jd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        td, tstate = ttx.update({k: torch.from_numpy(v) for k, v in
                                 g.items()}, tstate, tp)
        for k in SHAPES:
            _close(td[k], jd[k], f"{case} delta {k} step {i}")
            assert td[k].dtype == torch.float32
        assert int(tstate.count) == int(jstate.count) == i + 1
        for f in ("m", "v"):
            got, want = getattr(tstate, f), getattr(jstate, f)
            assert tuple(got.shape) == tuple(np.shape(want)), f
            _close(got, want, f"{case} {f} step {i}")
        jp = {k: jp[k] + jd[k] for k in SHAPES}
        tp = {k: tp[k] + td[k] for k in SHAPES}
        if i == 2 and case.startswith("lamb"):
            assert all((td[k] == 0).all() for k in SHAPES)


def test_transforms_are_pure_and_need_params():
    tx = tt.fused_adam(1e-2)
    p = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    state = tx.init(p)
    kept = [t.clone() for t in state]
    g = {k: torch.from_numpy(v) for k, v in _tree(1).items()}
    _, new = tx.update(g, state, p)
    assert all(torch.equal(a, b) for a, b in zip(state, kept))
    assert not torch.equal(new.m, state.m)
    assert isinstance(new, tt.FlatOptState)
    for name in ("fused_adam", "fused_lamb", "fused_sgd", "fused_novograd"):
        tx = getattr(tt, name)(1e-2)
        with pytest.raises(ValueError, match=f"{name} requires params"):
            tx.update(g, tx.init(p))
        with pytest.raises(ValueError, match=f"{name} requires params"):
            getattr(jt, name)(1e-2).update(
                {k: jnp.asarray(v.numpy()) for k, v in g.items()},
                getattr(jt, name)(1e-2).init(
                    {k: jnp.asarray(v.numpy()) for k, v in p.items()}))
