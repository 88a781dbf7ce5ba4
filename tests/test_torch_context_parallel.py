"""Port parity: context-parallel training of Llama and GPT through the ring.

The port's ``LlamaConfig(context_parallel=True)`` (sliding window 12, 4
heads over 2 kv heads, both layouts) and ``GPTConfig(context_parallel=
True)`` train through the in-process ring (``parallel_state.
initialize_model_parallel(1, 1, context_parallel_size_=cp)`` without
``torch.distributed``) at cp 2 and 4: the loss and every gradient against
JAX's model WITHOUT context parallelism on the same weights (a flax init
bridged by ``bridge.py``) and the same numpy batch, the JAX side computed
once per module with its kernels in interpret mode. The zigzag side takes
the batch through ``to_zigzag``; the mean loss does not depend on the
order. Tolerances: ``tests/test_llama_model.py``'s loss bar (2e-5) and
``tests/test_gpt_cp.py``'s gradient bar (rtol 2e-4, atol 2e-5); fp32.
Window 12 against S_loc 16 and S_h 8 at cp 4: the ring reaches one chunk
back, zigzag two half-chunks, with the rank's own offsets.

Then the port's example ``run_training`` on the CPU, in-process (both
layouts give the same losses, which fall) and over a 2-rank ``gloo`` group
(the same losses as in-process, within 1e-6); ``parallel_state``'s API and
refusals (a ``torch.distributed`` world of another size than cp among
them); the models' CP refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ring_worker import example_worker, run_ranks
from apex_tpu.models.gpt import GPTModel as JaxGPT
from apex_tpu.models.gpt import gpt_loss as jax_gpt_loss
from apex_tpu.models.gpt import gpt_tiny_config as jax_gpt_tiny
from apex_tpu.models.llama import LlamaModel as JaxLlama
from apex_tpu.models.llama import llama_loss as jax_llama_loss
from apex_tpu.models.llama import llama_tiny_config as jax_llama_tiny
from apex_tpu_torch.bridge import gpt_params_from_flax, llama_params_from_flax
from apex_tpu_torch.examples.long_context.train_ring_attention import (
    run_training)
from apex_tpu_torch.models import (GPTModel, LlamaModel, gpt_loss,
                                   gpt_tiny_config, llama_loss,
                                   llama_tiny_config)
from apex_tpu_torch.ops import to_zigzag
from apex_tpu_torch.ops.ring_attention import DistributedRing, LocalRing
from apex_tpu_torch.transformer import parallel_state

WINDOW, BATCH, SEQ = 12, 2, 64
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _no_ring_left():
    yield
    parallel_state.destroy_model_parallel()


def _batch(vocab):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _jax_side(model, loss_fn, bridge, ids, labels):
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(model, {"params": p}, jnp.asarray(ids),
                          jnp.asarray(labels), axis_name="unbound")))(
        variables["params"])
    tree = jax.tree.map(np.asarray, variables)
    return dict(state=bridge(tree), loss=float(loss),
                grads=bridge(jax.tree.map(np.asarray, grads)), ids=ids,
                labels=labels)


@pytest.fixture(scope="module")
def llama_ref():
    ids, labels = _batch(128)
    return _jax_side(JaxLlama(jax_llama_tiny(sliding_window=WINDOW)),
                     jax_llama_loss, llama_params_from_flax, ids, labels)


@pytest.fixture(scope="module")
def gpt_ref():
    ids, labels = _batch(128)
    return _jax_side(JaxGPT(jax_gpt_tiny()), jax_gpt_loss,
                     gpt_params_from_flax, ids, labels)


def _cp_step(model, loss_fn, ref, cp, layout):
    """The port's CP loss and gradients on the reference's batch."""
    ring = parallel_state.initialize_model_parallel(
        1, 1, context_parallel_size_=cp)
    assert isinstance(ring, LocalRing) and ring.size == cp
    ids, labels = (torch.from_numpy(a) for a in (ref["ids"], ref["labels"]))
    if layout == "zigzag":
        ids, labels = (to_zigzag(t, cp, axis=1) for t in (ids, labels))
    loss = loss_fn(model, ids, labels)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def _check(loss, grads, ref):
    np.testing.assert_allclose(loss, ref["loss"], **LOSS_TOL)
    assert set(grads) == set(ref["grads"])
    for name, g in grads.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), ref["grads"][name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("layout", ["ring", "zigzag"])
def test_llama_cp_matches_jax_without_cp(llama_ref, layout, cp):
    cfg = llama_tiny_config(sliding_window=WINDOW, context_parallel=True,
                            context_parallel_zigzag=layout == "zigzag")
    model = LlamaModel(cfg, device="cpu")
    model.load_state_dict(llama_ref["state"])
    _check(*_cp_step(model, llama_loss, llama_ref, cp, layout), llama_ref)


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("layout", ["ring", "zigzag"])
def test_gpt_cp_matches_jax_without_cp(gpt_ref, layout, cp):
    cfg = gpt_tiny_config(context_parallel=True,
                          context_parallel_zigzag=layout == "zigzag")
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(gpt_ref["state"])
    _check(*_cp_step(model, gpt_loss, gpt_ref, cp, layout), gpt_ref)


def test_cp_model_without_a_ring_attends_unsharded(llama_ref):
    """``context_parallel`` with no ring installed is the plain model, as
    the reference's CP branch needs a bound context axis."""
    cfg = llama_tiny_config(sliding_window=WINDOW, context_parallel=True)
    model = LlamaModel(cfg, device="cpu")
    model.load_state_dict(llama_ref["state"])
    loss = llama_loss(model, torch.from_numpy(llama_ref["ids"]),
                      torch.from_numpy(llama_ref["labels"]))
    np.testing.assert_allclose(loss.item(), llama_ref["loss"], **LOSS_TOL)


def test_cp_models_refuse_decoding_and_overlong_sequences():
    from apex_tpu_torch.models.generation import init_cache

    parallel_state.initialize_model_parallel(1, 1, context_parallel_size_=2)
    for cfg, cls in ((llama_tiny_config(context_parallel=True), LlamaModel),
                     (gpt_tiny_config(context_parallel=True), GPTModel)):
        model = cls(dataclasses.replace(cfg, max_position_embeddings=32),
                    device="cpu")
        with pytest.raises(ValueError, match="exceeds max_position"):
            model(torch.zeros(1, 64, dtype=torch.long))
        cache = init_cache(model.config, 1, 32, dtype=torch.float32,
                           device="cpu")
        with pytest.raises(ValueError, match="incremental decoding"):
            model(torch.zeros(1, 4, dtype=torch.long), cache=cache)


def test_parallel_state_api_and_refusals():
    with pytest.raises(RuntimeError, match="not initialized"):
        parallel_state.get_context_parallel_world_size()
    assert parallel_state.get_context_parallel_ring() is None
    ring = parallel_state.initialize_model_parallel(
        1, 1, context_parallel_size_=4)
    assert parallel_state.get_context_parallel_ring() is ring
    assert parallel_state.get_context_parallel_world_size() == 4
    assert parallel_state.get_context_parallel_rank() is None
    assert parallel_state.get_context_parallel_group() is None
    parallel_state.destroy_model_parallel()
    assert parallel_state.get_context_parallel_ring() is None
    # tensor parallelism needs its ranks as processes
    with pytest.raises(RuntimeError, match="needs 2 processes"):
        parallel_state.initialize_model_parallel(2, 1)
    with pytest.raises(NotImplementedError, match="queue A item 12.5"):
        parallel_state.initialize_model_parallel(1, 2)
    with pytest.raises(ValueError, match=">= 1"):
        parallel_state.initialize_model_parallel(context_parallel_size_=0)


def test_parallel_state_refuses_a_world_other_than_cp(tmp_path):
    """Under ``torch.distributed`` the ring is the world: a world of
    another size than cp (the reference's dp x cp mesh) raises, and cp
    equal to it gives the distributed ring."""
    parallel_state.destroy_model_parallel()
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1)
    try:
        with pytest.raises(NotImplementedError, match="queue A item 10"):
            parallel_state.initialize_model_parallel(
                1, 1, context_parallel_size_=2)
        assert parallel_state.get_context_parallel_ring() is None
        ring = parallel_state.initialize_model_parallel(
            1, 1, context_parallel_size_=1)
        assert isinstance(ring, DistributedRing)
        assert parallel_state.get_context_parallel_rank() == 0
    finally:
        parallel_state.destroy_model_parallel()
        torch.distributed.destroy_process_group()


def test_example_trains_in_process_on_the_cpu():
    quiet = dict(device="cpu", verbose=lambda *_: None)
    ring = run_training(**quiet)                      # the defaults
    zigzag = run_training(steps=3, layout="zigzag", **quiet)
    assert len(ring) == 8 and ring[-1] < ring[0]
    np.testing.assert_allclose(zigzag, ring[:3], rtol=1e-5)
    assert parallel_state.get_context_parallel_ring() is None
    with pytest.raises(ValueError, match="layout"):
        run_training(layout="ragged", **quiet)


@pytest.mark.parametrize("layout", ["ring", "zigzag"])
def test_example_over_gloo_equals_in_process(tmp_path, layout):
    """Two ranks, each with its chunk: the group's mean loss, the averaged
    gradients, the same FusedAdam steps as one process holding both."""
    steps = 3
    ranks = run_ranks(example_worker, 2, (layout, steps), tmp_path,
                      timeout=90)
    want = run_training(steps=steps, cp=2, layout=layout, device="cpu",
                        verbose=lambda *_: None)
    for losses in ranks:
        np.testing.assert_allclose(losses, want, rtol=1e-6, atol=1e-6)
