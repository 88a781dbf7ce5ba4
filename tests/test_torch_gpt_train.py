"""Port parity: training the tiny GPT through apex_tpu_torch vs apex_tpu.

A flax ``GPTModel.init`` (seed 0) goes through the weight bridge into the
port. The same numpy token ids then give ``gpt_loss`` and every gradient on
both sides (the JAX side through ``jax.value_and_grad``, its LayerNorm and
flash kernels in interpret mode): loss within 1e-5, gradients within atol
1e-4 / rtol 1e-3 per parameter, matched by bridged name. Then the JAX loop
of ``tests/test_gpt_model.py::test_gpt_train_smoke`` (8 FusedAdam steps,
lr 1e-3) against the port's ``FusedAdam`` over ``named_parameters()``:
per-step losses within 1e-4 relative, and the Adam moments carried across
by name through the same bridge. fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPTModel as JaxGPT
from apex_tpu.models.gpt import gpt_loss as jax_gpt_loss
from apex_tpu.models.gpt import gpt_tiny_config as jax_tiny
from apex_tpu.ops import flat_buffer as jax_flat
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.bridge import gpt_params_from_flax
from apex_tpu_torch.models import (GPTModel, gpt_loss, gpt_tiny_config,
                                   lm_token_loss)
from apex_tpu_torch.ops import flat_buffer
from apex_tpu_torch.ops.paged_attention import paged_attention
from apex_tpu_torch.optimizers import FusedAdam

STEPS = 8


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (4, 16)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    jm = JaxGPT(jax_tiny())
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    return jm, variables, ids, labels


def _port_model(variables):
    tm = GPTModel(gpt_tiny_config(), device="cpu")
    tm.load_state_dict(gpt_params_from_flax(
        jax.tree.map(np.asarray, variables)))
    return tm


def _jax_step(jm, ids, labels):
    return jax.jit(jax.value_and_grad(
        lambda p: jax_gpt_loss(jm, {"params": p}, jnp.asarray(ids),
                               jnp.asarray(labels), axis_name="unbound")))


def test_loss_and_every_gradient_match_jax(setup):
    jm, variables, ids, labels = setup
    jloss, jgrads = _jax_step(jm, ids, labels)(variables["params"])
    want = gpt_params_from_flax(jax.tree.map(np.asarray, jgrads))
    tm = _port_model(variables)
    loss = gpt_loss(tm, torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


def test_backward_gives_every_parameter_a_finite_gradient():
    tm = GPTModel(gpt_tiny_config(), device="cpu",
                  generator=torch.Generator().manual_seed(3))
    ids = torch.randint(0, 128, (2, 24), generator=torch.Generator()
                        .manual_seed(4))
    gpt_loss(tm, ids, torch.roll(ids, -1, 1)).backward()
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        if "position" not in name and "word" not in name:
            assert p.grad.abs().sum() > 0, name


def test_lm_token_loss_is_mean_nll_in_fp32():
    logits = torch.randn(2, 5, 11, generator=torch.Generator()
                         .manual_seed(5)).bfloat16()
    labels = torch.randint(0, 11, (2, 5))
    got = lm_token_loss(logits, labels)
    assert got.dtype == torch.float32 and got.ndim == 0
    want = torch.nn.functional.cross_entropy(logits.float().reshape(-1, 11),
                                             labels.reshape(-1))
    torch.testing.assert_close(got, want)


def test_fused_adam_training_matches_the_jax_loop(setup):
    jm, variables, ids, labels = setup
    step = _jax_step(jm, ids, labels)
    params = variables["params"]
    jopt = JaxFusedAdam(params, lr=1e-3)
    jlosses = []
    for _ in range(STEPS):
        loss, g = step(params)
        params = jopt.step(g)
        jlosses.append(float(loss))

    tm = _port_model(variables)
    opt = FusedAdam(tm.named_parameters(), lr=1e-3)
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)
    losses = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = gpt_loss(tm, tids, tlabels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    assert int(opt.step_count) == STEPS

    # the optimizers' state, carried across by name (the flat segment order
    # differs: JAX flattens its tree in sorted-key order)
    names = dict(tm.named_parameters())
    for buf in ("m", "v"):
        jtree = jax_flat.unflatten(jopt.state[buf], jopt.spec)
        want = gpt_params_from_flax(jax.tree.map(np.asarray, jtree))
        got = flat_buffer.unflatten(opt.state[buf], opt.spec)
        assert set(got) == set(names)
        for name in names:
            scale = float(np.abs(want[name].numpy()).max()) or 1.0
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       atol=1e-3 * scale, rtol=1e-3,
                                       err_msg=f"{buf} {name}")


def test_paged_attention_under_grad_raises():
    """The paged kernel has no backward (nor has the reference's): a call
    on an input that requires grad raises, on the CPU as on the card."""
    q = torch.zeros(1, 2, 1, 8, requires_grad=True)
    pages = torch.zeros(3, 2, 4, 8)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        paged_attention(q, pages, pages, bt, ln)
    with torch.no_grad():
        assert paged_attention(q, pages, pages, bt, ln).shape == (1, 2, 1, 8)
