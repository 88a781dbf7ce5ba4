"""Port parity: BERT pretraining through apex_tpu_torch vs apex_tpu.

A flax ``BertForPreTraining.init`` (``bert_tiny_config``: 2 layers, hidden
128, 4 heads; attention dropout 0.1, hidden dropout 0) goes through
``bert_params_from_flax`` into the port. One batch from ``synthetic_batch``
(B = 2, S = 32, numpy seed 0, the second row's last 8 tokens padded) then
gives, on both sides: the dense and the gathered MLM logits and the NSP
logits (atol = rtol = 1e-5), the pretraining loss with dropout on (the
attention keep masks are the reference's bit for bit; loss within 1e-5) and
every gradient (atol 1e-4 / rtol 1e-3, matched by bridged name), and three
``FusedLAMB`` steps (losses within 1e-4 relative, parameters within atol
1e-4 / rtol 1e-3). The JAX side runs once per module, its flash, LayerNorm
and xentropy kernels in interpret mode. fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import BertForPreTraining as JaxBert
from apex_tpu.models import bert_tiny_config as jax_tiny
from apex_tpu.models import make_pretrain_step
from apex_tpu.models import synthetic_batch as jax_synthetic_batch
from apex_tpu.models.bert import bert_pretrain_loss as jax_pretrain_loss
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu_torch.bridge import bert_params_from_flax
from apex_tpu_torch.models import (BertForPreTraining, bert_large_config,
                                   bert_pretrain_loss, bert_pretrain_loss_fn,
                                   bert_tiny_config, synthetic_batch)
from apex_tpu_torch.models import bert as port_bert
from apex_tpu_torch.optimizers import FusedLAMB

B, S, SEED, LAMB_STEPS = 2, 32, 3, 3


def _no_decay(name):
    return "bias" in name or "norm" in name.lower()


@pytest.fixture(scope="module")
def ref():
    """Everything the JAX side computes, once."""
    cfg = jax_tiny(attention_dropout=0.1)
    model = JaxBert(cfg)
    batch = dict(jax_synthetic_batch(np.random.default_rng(0), cfg, B, S))
    mask = np.ones((B, S), np.int32)
    mask[1, -8:] = 0
    batch["attention_mask"] = jnp.asarray(mask)
    params = model.init(jax.random.PRNGKey(0), batch["input_ids"],
                        batch["token_type_ids"],
                        batch["attention_mask"])["params"]
    args = (batch["input_ids"], batch["token_type_ids"],
            batch["attention_mask"])
    dense = model.apply({"params": params}, *args)
    gathered = model.apply({"params": params}, *args,
                           masked_positions=batch["mlm_positions"])
    step = make_pretrain_step(model)
    loss, grads = step(params, batch, SEED)
    opt = JaxFusedLAMB(params, lr=1e-3, weight_decay=0.01,
                       exclude_from_weight_decay=_no_decay)
    p, losses = params, []
    for i in range(LAMB_STEPS):
        step_loss, g = step(p, batch, i)
        p = opt.step(g)
        losses.append(float(step_loss))

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    return dict(cfg=cfg, batch={k: np.asarray(v) for k, v in batch.items()},
                params=np_tree(params), dense=np_tree(dense),
                gathered=np_tree(gathered), loss=float(loss),
                grads=np_tree(grads), lamb_losses=losses,
                lamb_params=np_tree(p))


def _port(ref):
    model = BertForPreTraining(bert_tiny_config(attention_dropout=0.1),
                               device="cpu")
    model.load_state_dict(bert_params_from_flax(ref["params"]))
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in ref["batch"].items()}
    return model, batch


def test_bridge_maps_every_leaf_and_refuses_strangers(ref):
    sd = bert_params_from_flax(ref["params"])
    model = BertForPreTraining(bert_tiny_config(), device="cpu")
    assert set(sd) == set(model.state_dict())
    assert len(sd) == len(jax.tree.leaves(ref["params"]))
    extra = dict(ref["params"], stray_weight=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="stray_weight"):
        bert_params_from_flax(extra)
    layer = dict(ref["params"]["layer_1"])
    del layer["mlp_bias2"]
    with pytest.raises(KeyError, match="mlp_bias2"):
        bert_params_from_flax(dict(ref["params"], layer_1=layer))


def test_dense_and_gathered_logits_match_jax(ref):
    model, batch = _port(ref)
    args = (batch["input_ids"], batch["token_type_ids"],
            batch["attention_mask"])
    with torch.no_grad():
        dense = model(*args)
        gathered = model(*args, masked_positions=batch["mlm_positions"])
    for got, want in zip(dense + gathered, ref["dense"] + ref["gathered"]):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert gathered[0].shape == (B, batch["mlm_positions"].shape[1],
                                 ref["cfg"].vocab_size)


def test_pretrain_loss_and_every_gradient_match_jax(ref):
    model, batch = _port(ref)
    loss = bert_pretrain_loss_fn(model, batch, SEED)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], atol=1e-5,
                               rtol=1e-5)
    want = bert_params_from_flax(ref["grads"])
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


def test_attention_dropout_changes_the_loss_by_seed(ref):
    """The seed reaches the attention masks: two seeds differ, one seed
    repeats exactly, and deterministic mode ignores it."""
    model, batch = _port(ref)
    with torch.no_grad():
        a, b, a2 = (bert_pretrain_loss_fn(model, batch, s).item()
                    for s in (SEED, SEED + 1, SEED))
    assert a == a2 and a != b
    assert port_bert.layer_dropout_seed(2 ** 31, 0) == \
        int(np.int32(np.int64(2 ** 31) * 1000003 % 2 ** 32 - 2 ** 32))


def test_fused_lamb_loop_matches_jax(ref):
    model, batch = _port(ref)
    opt = FusedLAMB(model.named_parameters(), lr=1e-3, weight_decay=0.01,
                    exclude_from_weight_decay=_no_decay)
    losses = []
    for i in range(LAMB_STEPS):
        opt.zero_grad()
        loss = bert_pretrain_loss_fn(model, batch, i)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, ref["lamb_losses"], rtol=1e-4)
    want = bert_params_from_flax(ref["lamb_params"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


def test_pretrain_loss_matches_jax_on_random_logits():
    rng = np.random.default_rng(9)
    mlm = rng.standard_normal((2, 5, 50)).astype(np.float32)
    nsp = rng.standard_normal((2, 2)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 5)).astype(np.int32)
    labels[0, :2] = 0
    nsp_labels = np.array([1, 0], np.int32)
    want = jax_pretrain_loss(*(jnp.asarray(a) for a in (mlm, nsp, labels,
                                                        nsp_labels)))
    got = bert_pretrain_loss(*(torch.from_numpy(a) for a in
                               (mlm, nsp, labels, nsp_labels)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_synthetic_batch_equals_the_reference():
    for b, s in ((3, 40), (2, 512)):
        want = jax_synthetic_batch(np.random.default_rng(5), jax_tiny(), b, s)
        got = synthetic_batch(np.random.default_rng(5), bert_tiny_config(),
                              b, s, device="cpu")
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
    assert synthetic_batch(np.random.default_rng(0), bert_large_config(), 8,
                           512, device="cpu")["mlm_positions"].shape == (8, 80)


def test_hidden_dropout_keep_share_and_scale():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200, 500)
    y = port_bert.hidden_dropout(x, 0.1, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    yb = port_bert.hidden_dropout(x.bfloat16(), 0.1, gen)
    assert yb.dtype == torch.bfloat16


def test_hidden_dropout_is_seeded_and_on_only_in_training():
    cfg = bert_tiny_config(hidden_dropout=0.1)
    model = BertForPreTraining(cfg, device="cpu")
    ids = torch.randint(4, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        det = model(ids)[1]
        a, b, a2 = (model(ids, deterministic=False, dropout_seed=s)[1]
                    for s in (1, 2, 1))
    torch.testing.assert_close(model(ids)[1].detach(), det, atol=0, rtol=0)
    assert torch.equal(a, a2) and not torch.equal(a, b)
    assert not torch.equal(a, det)


def test_unported_surface_raises():
    """``remat`` (once refused here) builds and runs; the partition specs
    still wait for tensor parallelism."""
    model = BertForPreTraining(bert_tiny_config(remat=True), device="cpu")
    assert model(torch.ones(1, 8, dtype=torch.int32))[1].shape == (1, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_bert.param_partition_specs({})


def _loss_and_grads(model, batch, seed, deterministic=False):
    positions = batch["mlm_positions"]
    mlm, nsp = model(batch["input_ids"], batch["token_type_ids"],
                     batch["attention_mask"], deterministic=deterministic,
                     dropout_seed=seed, masked_positions=positions)
    loss = bert_pretrain_loss(mlm, nsp, batch["mlm_gathered_labels"],
                              batch["nsp_labels"])
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


@pytest.mark.parametrize("replay", [True, False],
                         ids=["replayed", "control_without_replay"])
def test_remat_replays_hidden_dropout(ref, replay, monkeypatch):
    """Remat against no remat, hidden and attention dropout 0.1: the same
    loss and every gradient bit for bit, because the recompute replays
    the layer's generator state. The control drops the replay (the
    recompute then draws new masks) and must differ."""
    if not replay:
        monkeypatch.setattr(port_bert, "_replaying", lambda run, gen: run)
    out = []
    for remat in (False, True):
        cfg = bert_tiny_config(attention_dropout=0.1, hidden_dropout=0.1,
                               remat=remat)
        model = BertForPreTraining(cfg, device="cpu")
        model.load_state_dict(bert_params_from_flax(ref["params"]))
        batch = {k: torch.from_numpy(np.array(v))
                 for k, v in ref["batch"].items()}
        out.append(_loss_and_grads(model, batch, SEED))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    same = [torch.equal(g0[n], g1[n]) for n in g0]
    assert all(same) if replay else not all(same)


def test_remat_matches_jax_remat_deterministic(ref):
    """``remat=True`` with dropout off against JAX's ``nn.remat`` model:
    the loss (1e-5) and every gradient (atol 1e-4 / rtol 1e-3)."""
    cfg = jax_tiny(remat=True)
    model = JaxBert(cfg)
    batch = {k: jnp.asarray(v) for k, v in ref["batch"].items()}

    def loss_fn(p):
        mlm, nsp = model.apply(
            {"params": p}, batch["input_ids"], batch["token_type_ids"],
            batch["attention_mask"], deterministic=True,
            masked_positions=batch["mlm_positions"])
        return jax_pretrain_loss(mlm, nsp, batch["mlm_gathered_labels"],
                                 batch["nsp_labels"])

    params = jax.tree.map(jnp.asarray, ref["params"])
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    port = BertForPreTraining(bert_tiny_config(remat=True), device="cpu")
    port.load_state_dict(bert_params_from_flax(ref["params"]))
    tbatch = {k: torch.from_numpy(np.array(v))
              for k, v in ref["batch"].items()}
    loss, grads = _loss_and_grads(port, tbatch, 0, deterministic=True)
    np.testing.assert_allclose(loss, float(want_loss), atol=1e-5, rtol=1e-5)
    named = bert_params_from_flax(jax.tree.map(np.asarray, want_grads))
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), named[n].numpy(), atol=1e-4,
                                   rtol=1e-3, err_msg=n)
