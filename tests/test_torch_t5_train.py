"""Port parity: training the tiny T5 through apex_tpu_torch vs apex_tpu.

A flax ``T5Model.init`` (seed 0) of ``t5_tiny_config`` (relu, tied head;
and gated-gelu with an untied head) goes through
``bridge.t5_params_from_flax`` into the port. The same numpy token ids (B =
2, 12 encoder and 9 decoder tokens, labels the decoder ids shifted left)
give ``t5_loss`` and every gradient on both sides, the JAX side through
``jax.value_and_grad`` with its RMSNorm and flash kernels (the bias branch
forward and backward) in interpret mode: loss within 1e-5, gradients
within atol 1e-4 / rtol 1e-3 per parameter, matched by bridged name. Both
relative-bias tables get a gradient of exactly 0 on both sides: the
reference's flash backward returns zeros for its bias, and the port copies
it. Then three FusedAdam steps (lr 1e-3) against the JAX loop: per-step
losses within 1e-4 relative and every parameter after them within 1e-4 of
each tensor's largest entry (rtol 1e-3). fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import t5 as jax_t5
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.bridge import t5_params_from_flax
from apex_tpu_torch.models import T5Model, t5_loss, t5_tiny_config
from apex_tpu_torch.optimizers import FusedAdam

B, S_ENC, S_DEC, STEPS, LR = 2, 12, 9, 3, 1e-3
VARIANTS = {"relu_tied": {},
            "gated_untied": dict(ff_act="gated-gelu",
                                 tie_word_embeddings=False)}
TABLES = ("enc_rel_bias.rel_attn_bias", "dec_rel_bias.rel_attn_bias")


def _bridge(tree):
    return t5_params_from_flax(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module", params=list(VARIANTS))
def setup(request):
    kw = VARIANTS[request.param]
    rng = np.random.default_rng(0)
    enc = rng.integers(0, 128, (B, S_ENC)).astype(np.int32)
    dec = rng.integers(0, 128, (B, S_DEC)).astype(np.int32)
    labels = np.roll(dec, -1, axis=1)
    jm = jax_t5.T5Model(jax_t5.t5_tiny_config(**kw))
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(enc),
                        jnp.asarray(dec))
    step = jax.jit(jax.value_and_grad(
        lambda p: jax_t5.t5_loss(jm, {"params": p}, jnp.asarray(enc),
                                 jnp.asarray(dec), jnp.asarray(labels),
                                 axis_name="unbound")))
    loss, grads = step(variables["params"])
    return dict(kw=kw, variables=variables, step=step, loss=float(loss),
                grads=_bridge(grads),
                data=tuple(torch.from_numpy(a) for a in (enc, dec, labels)))


def _port_model(setup):
    tm = T5Model(t5_tiny_config(**setup["kw"]), device="cpu")
    tm.load_state_dict(_bridge(setup["variables"]))
    return tm


def test_loss_and_every_gradient_match_jax(setup):
    tm = _port_model(setup)
    loss = t5_loss(tm, *setup["data"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), setup["loss"], rtol=1e-5,
                               atol=1e-5)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    want = setup["grads"]
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4,
                                   rtol=1e-3, err_msg=name)
    for name in TABLES:
        assert not want[name].any() and not grads[name].any(), name
    # the rest train: every block weight has a nonzero gradient
    assert all(grads[n].any() for n in grads if n not in TABLES)


def test_fused_adam_steps_match_the_jax_loop(setup):
    params = setup["variables"]["params"]
    jopt = JaxFusedAdam(params, lr=LR)
    jlosses = []
    for _ in range(STEPS):
        loss, g = setup["step"](params)
        params = jopt.step(g)
        jlosses.append(float(loss))

    tm = _port_model(setup)
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = FusedAdam(tm.named_parameters(), lr=LR)
    losses = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = t5_loss(tm, *setup["data"])
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    want = _bridge(params)
    for name, p in tm.named_parameters():
        scale = float(np.abs(want[name].numpy()).max())
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-4 * scale, rtol=1e-3,
                                   err_msg=name)
    # a zero gradient leaves each table where it started (no decay here)
    for name in TABLES:
        torch.testing.assert_close(dict(tm.named_parameters())[name].detach(),
                                   start[name], atol=0, rtol=0)
