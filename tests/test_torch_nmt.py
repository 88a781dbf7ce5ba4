"""Port parity: the NMT Transformer example (BASELINE config #3) in
apex_tpu_torch against the reference's ``examples/nmt/main.py``.

The reference example is loaded by path (as ``tests/test_examples.py``
does) and its ``NMTTransformer`` (vocab 64, E 64, 4 heads, FFN 128, 2 + 2
layers) initialised from seed 0 on a batch of 4 x 8 drawn by its own
``synthetic_copy_batch``; the flax tree goes through
``bridge.nmt_params_from_flax`` into the port's model on the CPU. The
loss (label smoothing 0.1) within 1e-5 and every gradient within atol
1e-4 / rtol 1e-3, matched by bridged name; then four ``FusedAdam(lr=3e-4)``
steps, each on a fresh batch from the same ``default_rng``, against the
reference's loop: the losses within 1e-4 relative (as
``tests/test_torch_t5_train.py``). The JAX side runs its flash and norm
kernels in interpret mode and is computed once per module. Also: the
batches equal the reference's bit for bit, ``run_training`` drives the
code the tests hold, and the bridge refuses an extra or a missing leaf.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.bridge import nmt_params_from_flax
from apex_tpu_torch.examples.nmt import main as port_nmt
from apex_tpu_torch.optimizers import FusedAdam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=64, embed_dim=64, num_heads=4, ffn_dim=128,
           num_layers=2)
B, S, STEPS, LR, LS = 4, 8, 4, 3e-4, 0.1


def _load_reference():
    name = "example_nmt_reference"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", "nmt", "main.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod      # flax looks the module up
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _bridge(tree):
    return nmt_params_from_flax(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def ref():
    """The reference's model, variables, loss step and its loop's losses
    and batches."""
    nmt = _load_reference()
    model = nmt.NMTTransformer(**CFG)
    rng = np.random.default_rng(0)
    src, tgt_in, _ = nmt.synthetic_copy_batch(rng, B, S, CFG["vocab_size"])
    variables = model.init(jax.random.PRNGKey(0), src, tgt_in)
    from apex_tpu.contrib.xentropy import SoftmaxCrossEntropyLoss

    criterion = SoftmaxCrossEntropyLoss()

    def loss_fn(p, src, tgt_in, tgt_out):
        logits = model.apply({"params": p}, src, tgt_in, train=True)
        return criterion(logits.reshape(-1, CFG["vocab_size"]).astype(
            jnp.float32), tgt_out.reshape(-1), smoothing=LS).mean()

    step = jax.jit(jax.value_and_grad(loss_fn))
    batch0 = nmt.synthetic_copy_batch(np.random.default_rng(1), B, S,
                                      CFG["vocab_size"])
    loss, grads = step(variables["params"], *batch0)
    params = variables["params"]
    opt = JaxFusedAdam(params, lr=LR)
    batches, losses = [], []
    for _ in range(STEPS):
        batch = nmt.synthetic_copy_batch(rng, B, S, CFG["vocab_size"])
        batches.append(batch)
        l, g = step(params, *batch)
        params = opt.step(g)
        losses.append(float(l))
    return dict(nmt=nmt, variables=variables, batch0=batch0,
                loss=float(loss), grads=_bridge(grads),
                batches=batches, losses=losses)


def _port_model(ref):
    m = port_nmt.NMTTransformer(**CFG, device="cpu")
    m.load_state_dict(_bridge(ref["variables"]))
    return m


def _t(batch):
    return tuple(torch.from_numpy(np.array(a)) for a in batch)


def test_loss_and_every_gradient_match_jax(ref):
    m = _port_model(ref)
    loss = port_nmt.nmt_loss(m, *_t(ref["batch0"]), label_smoothing=LS)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5,
                               atol=1e-5)
    grads = {n: p.grad for n, p in m.named_parameters()}
    want = ref["grads"]
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4,
                                   rtol=1e-3, err_msg=name)
    assert all(g.any() for g in grads.values())


def test_fused_adam_steps_match_the_jax_loop(ref):
    m = _port_model(ref)
    opt = FusedAdam(m.named_parameters(), lr=LR)
    rng = np.random.default_rng(0)
    port_nmt.synthetic_copy_batch(rng, B, S, CFG["vocab_size"], "cpu")
    losses = []
    for want in ref["batches"]:
        batch = port_nmt.synthetic_copy_batch(rng, B, S, CFG["vocab_size"],
                                              "cpu")
        for got, w in zip(batch, want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        losses.append(port_nmt.train_step(m, opt, batch, LS).item())
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)


@pytest.mark.parametrize("seed,batch,seq,vocab", [(0, 4, 8, 64),
                                                  (3, 32, 32, 256)])
def test_synthetic_copy_batch_equals_the_reference(ref, seed, batch, seq,
                                                   vocab):
    got = port_nmt.synthetic_copy_batch(np.random.default_rng(seed), batch,
                                        seq, vocab, "cpu")
    want = ref["nmt"].synthetic_copy_batch(np.random.default_rng(seed),
                                           batch, seq, vocab)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    src, tgt_in, tgt_out = got
    assert (tgt_in[:, 0] == 1).all() and torch.equal(tgt_in[:, 1:],
                                                     src[:, :-1])
    assert torch.equal(src, tgt_out) and (src >= 2).all()


def test_run_training_lowers_the_loss():
    losses = port_nmt.run_training(steps=12, batch=8, seq=8, vocab=32,
                                   lr=3e-3, verbose=lambda *a: None,
                                   device="cpu")
    assert len(losses) == 12 and losses[-1] < losses[0]


def test_the_port_is_built_like_the_reference(ref):
    """Every bridged name is a port parameter of the same shape, and the
    port's init draws what the reference's initialisers describe."""
    sd = _bridge(ref["variables"])
    m = port_nmt.NMTTransformer(**CFG, device="cpu")
    params = {n: p.detach() for n, p in m.named_parameters()}
    assert {n: tuple(t.shape) for n, t in sd.items()} == {
        n: tuple(p.shape) for n, p in params.items()}
    assert params["enc_layers.0.fc1.weight"].shape == (128, 64)
    assert float(params["embed"].std()) == pytest.approx(0.02, rel=0.1)
    bound = (6.0 / (4 * 64)) ** 0.5
    w = params["dec_layers.1.self_attn.qkv_weight"]
    assert float(w.abs().max()) <= bound
    assert not params["enc_layers.0.fc1.bias"].any()


def test_bridge_refuses_an_extra_or_a_missing_leaf(ref):
    params = jax.tree.map(np.asarray, ref["variables"]["params"])
    extra = dict(params, enc_9={"fc1": {"kernel": np.zeros((2, 2))}})
    with pytest.raises(KeyError):
        nmt_params_from_flax(extra)
    with pytest.raises(KeyError):
        nmt_params_from_flax(dict(params, stray=np.zeros(3)))
    short = dict(params, dec_1={k: v for k, v in params["dec_1"].items()
                                if k != "cross_attn"})
    with pytest.raises(KeyError):
        nmt_params_from_flax(short)
    with pytest.raises(KeyError):
        nmt_params_from_flax({k: v for k, v in params.items()
                              if k != "pos"})
