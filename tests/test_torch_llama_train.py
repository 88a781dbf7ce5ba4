"""Port parity: training the tiny windowed Llama through apex_tpu_torch vs
apex_tpu.

A flax ``LlamaModel.init`` (seed 0) of ``llama_tiny_config(num_layers=2,
sliding_window=8)`` (4 heads over 2 kv heads) goes through
``bridge.llama_params_from_flax`` into the port. The same numpy token ids
(B = 2, S = 64: rows past the first 8 positions see the band only) give
``llama_loss`` and every gradient on both sides, the JAX side through
``jax.value_and_grad`` with its RMSNorm and windowed flash kernels in
interpret mode (computed once per module): loss within 1e-5, gradients
within atol 1e-4 / rtol 1e-3 per parameter, matched by bridged name. Then
the JAX loop of FusedAdam steps (lr 1e-3) against the port's
``FusedAdam`` over ``named_parameters()``: per-step losses within 1e-4
relative, and the Adam moments, carried across by name, within 1e-3 of
each tensor's largest (as ``tests/test_torch_gpt_train.py``). And
``remat`` gives the same loss and gradients, as the reference's
``test_llama_remat_same_loss_and_grads``. fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.llama import LlamaModel as JaxLlama
from apex_tpu.models.llama import llama_loss as jax_llama_loss
from apex_tpu.models.llama import llama_tiny_config as jax_tiny
from apex_tpu.ops import flat_buffer as jax_flat
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.bridge import llama_params_from_flax
from apex_tpu_torch.models import LlamaModel, llama_loss, llama_tiny_config
from apex_tpu_torch.ops import flat_buffer
from apex_tpu_torch.optimizers import FusedAdam

WINDOW, LAYERS, BATCH, SEQ, STEPS, LR = 8, 2, 2, 64, 3, 1e-3


def _bridge(tree):
    return llama_params_from_flax(jax.tree.map(np.asarray, tree))


def _jax_step(jm, ids, labels):
    return jax.jit(jax.value_and_grad(
        lambda p: jax_llama_loss(jm, {"params": p}, jnp.asarray(ids),
                                 jnp.asarray(labels), axis_name="unbound")))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (BATCH, SEQ)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    jm = JaxLlama(jax_tiny(num_layers=LAYERS, sliding_window=WINDOW))
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    step = _jax_step(jm, ids, labels)
    loss, grads = step(variables["params"])
    return dict(jm=jm, variables=variables, ids=ids, labels=labels,
                step=step, loss=float(loss), grads=_bridge(grads))


def _port_model(variables, **overrides):
    cfg = llama_tiny_config(num_layers=LAYERS, sliding_window=WINDOW)
    tm = LlamaModel(dataclasses.replace(cfg, **overrides), device="cpu")
    tm.load_state_dict(_bridge(variables))
    return tm


def _loss_and_grads(tm, ids, labels):
    loss = llama_loss(tm, torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in tm.named_parameters()}


def test_loss_and_every_gradient_match_jax(setup):
    tm = _port_model(setup["variables"])
    loss, grads = _loss_and_grads(tm, setup["ids"], setup["labels"])
    np.testing.assert_allclose(loss, setup["loss"], rtol=1e-5, atol=1e-5)
    want = setup["grads"]
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4,
                                   rtol=1e-3, err_msg=name)


def test_fused_adam_steps_match_the_jax_loop(setup):
    params = setup["variables"]["params"]
    jopt = JaxFusedAdam(params, lr=LR)
    jlosses = []
    for _ in range(STEPS):
        loss, g = setup["step"](params)
        params = jopt.step(g)
        jlosses.append(float(loss))

    tm = _port_model(setup["variables"])
    opt = FusedAdam(tm.named_parameters(), lr=LR)
    ids, labels = (torch.from_numpy(a) for a in (setup["ids"],
                                                 setup["labels"]))
    losses = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = llama_loss(tm, ids, labels)
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
        want = _bridge(jax_flat.unflatten(jopt.state[buf], jopt.spec))
        got = flat_buffer.unflatten(opt.state[buf], opt.spec)
        assert set(got) == set(names)
        for name in names:
            scale = float(np.abs(want[name].numpy()).max()) or 1.0
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       atol=1e-3 * scale, rtol=1e-3,
                                       err_msg=f"{buf} {name}")


def test_remat_gives_the_same_loss_and_gradients(setup):
    """``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``); the loss and every gradient are those of
    the plain model (the same fp32 ops in the same order on the CPU)."""
    base = _loss_and_grads(_port_model(setup["variables"]), setup["ids"],
                           setup["labels"])
    tm = _port_model(setup["variables"], remat=True)
    assert tm.config.remat
    got = _loss_and_grads(tm, setup["ids"], setup["labels"])
    np.testing.assert_allclose(got[0], base[0], rtol=1e-6, atol=1e-6)
    for name, g in got[1].items():
        np.testing.assert_allclose(g.numpy(), base[1][name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_remat_recomputes_the_blocks_in_the_backward(monkeypatch):
    """Under remat each block's forward runs twice per step (once more in
    the backward); under no_grad, or without remat, once."""
    from apex_tpu_torch.models import llama as llama_mod

    calls = []
    real = llama_mod.LlamaDecoderBlock.forward

    def counting(self, *args, **kw):
        calls.append(1)
        return real(self, *args, **kw)

    monkeypatch.setattr(llama_mod.LlamaDecoderBlock, "forward", counting)
    ids = torch.zeros(1, 12, dtype=torch.long)
    for remat, want in ((False, LAYERS), (True, 2 * LAYERS)):
        tm = LlamaModel(dataclasses.replace(
            llama_tiny_config(num_layers=LAYERS, sliding_window=WINDOW),
            remat=remat), device="cpu")
        calls.clear()
        llama_loss(tm, ids, ids).backward()
        assert len(calls) == want
        calls.clear()
        with torch.no_grad():
            tm(ids)
        assert len(calls) == LAYERS

