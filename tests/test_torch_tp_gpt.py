"""Tensor-parallel tiny GPT over spawned ``gloo`` ranks against the JAX
package: the cases of ``tests/test_gpt_model.py:55-139``.

One tp = 1 weight set from the JAX model (``bridge.gpt_params_from_flax``)
is cut into each rank's shard (``bridge.shard_gpt_params``); the port's
ranks at tp 2 and 4 compute the loss and every gradient of their shard.
They are held to JAX's tp = 1 loss and gradients (cut the same way), and
at tp 4 to JAX's own tensor-parallel model on the forced CPU mesh (its
``shard_map`` over the ``model`` axis, loss and per-shard gradients), at
the JAX package's TP bar: loss ``2e-5``, gradients ``rtol 5e-3, atol
1e-4``. Also ``shard_gpt_params`` against JAX's ``shard_model_variables``
layout, and its round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_tp_worker import gpt_train_worker
from apex_tpu.mesh import MODEL_AXIS
from apex_tpu.models.gpt import GPTModel, gpt_loss, gpt_tiny_config
from apex_tpu_torch.bridge import (gpt_params_from_flax, shard_gpt_params,
                                   unshard_gpt_params)
from apex_tpu_torch.parallel import run_ranks

TPS = (2, 4)
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's tiny GPT at tp = 1 (variables, loss, gradients) and its tp = 4
    loss and per-shard gradients, on one batch."""
    rng = np.random.default_rng(0)
    cfg = gpt_tiny_config()
    ids = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    m1 = GPTModel(cfg)
    v1 = m1.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    loss1, g1 = jax.value_and_grad(lambda p: gpt_loss(
        m1, {"params": p}, ids, labels, axis_name="unbound"))(v1["params"])

    from apex_tpu.transformer import parallel_state

    sd = {k: v.numpy() for k, v in gpt_params_from_flax(_numpy(v1)).items()}
    m4 = GPTModel(gpt_tiny_config(tensor_parallel_size=4))
    shards = [shard_gpt_params({k: torch.from_numpy(v) for k, v in
                                sd.items()}, 4, r) for r in range(4)]
    # the flax tree of rank r's shard: the port's names back to flax paths
    v4 = jax.eval_shape(lambda: m4.init(jax.random.PRNGKey(0), ids))

    def to_flax(shard):
        def leaf(path, _):
            name = "/".join(str(getattr(k, "key", k)) for k in path)
            head, _, rest = name.partition("/")
            key = (f"layers.{head[6:]}.{rest.replace('/', '.')}"
                   if head.startswith("layer_") else name.replace("/", "."))
            return shard[key].numpy()
        return jax.tree_util.tree_map_with_path(leaf, v4["params"])

    stacked = jax.tree.map(lambda *xs: np.stack(xs),
                           *[to_flax(s) for s in shards])
    mesh = parallel_state.initialize_model_parallel(4)
    try:
        def run(vs, ii, ll):
            v = jax.tree.map(lambda t: t[0], vs)
            loss, g = jax.value_and_grad(
                lambda p: gpt_loss(m4, {"params": p}, ii, ll))(v)
            return loss.reshape(1), jax.tree.map(lambda t: t[None], g)

        # check_vma=False: interpreted Pallas kernels cannot run under the
        # vma checker (as tests/test_gpt_model.py runs this model)
        loss4, g4 = jax.shard_map(run, mesh=mesh,
                                  in_specs=(P(MODEL_AXIS), P(), P()),
                                  out_specs=P(MODEL_AXIS), check_vma=False)(
            stacked, ids, labels)
    finally:
        parallel_state.destroy_model_parallel()
    g4 = _numpy(g4)
    g4_ranks = [gpt_params_from_flax(jax.tree.map(lambda t: t[r], g4))
                for r in range(4)]
    return dict(ids=ids, labels=labels, sd=sd, loss1=float(loss1),
                g1=gpt_params_from_flax(_numpy(g1)),
                loss4=np.asarray(loss4), g4=g4_ranks, v1=_numpy(v1))


@pytest.fixture(scope="module")
def port(jax_side):
    """tp -> every rank's loss and gradients."""
    j = jax_side
    return {tp: run_ranks(gpt_train_worker, tp,
                          (j["sd"], j["ids"], j["labels"], {}), threads=1,
                          timeout=120) for tp in TPS}


@pytest.mark.parametrize("tp", TPS)
def test_tp_loss_matches_jax_tp1(port, jax_side, tp):
    for r in range(tp):
        np.testing.assert_allclose(port[tp][r]["loss"], jax_side["loss1"],
                                   **LOSS_TOL)


@pytest.mark.parametrize("tp", TPS)
def test_tp_grads_match_jax_tp1(port, jax_side, tp):
    """Each rank's gradients against the matching shard of JAX's tp = 1
    gradients; replicated tensors (norms, position table, row-parallel
    biases) get the whole gradient on every rank."""
    for r in range(tp):
        want = shard_gpt_params(jax_side["g1"], tp, r)
        got = port[tp][r]["grads"]
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name].numpy(),
                                       err_msg=name, **GRAD_TOL)


def test_tp4_matches_jax_tp4(port, jax_side):
    for r in range(4):
        np.testing.assert_allclose(port[4][r]["loss"],
                                   jax_side["loss4"][r], **LOSS_TOL)
        for name, want in jax_side["g4"][r].items():
            np.testing.assert_allclose(port[4][r]["grads"][name],
                                       want.numpy(), err_msg=name,
                                       **GRAD_TOL)


@pytest.mark.parametrize("tp", TPS)
def test_tp1_model_in_a_tp_rank_keeps_full_vocab(port, jax_side, tp):
    """A tp = 1 GPT evaluated inside a rank of a tp-rank group: its logits
    are full-vocab because its config says so, whatever groups the process
    holds, so its loss is JAX's tp = 1 loss and its greedy tokens are the
    port's tp = 1 tokens outside any group, as the rank's TP shard's are
    (exact: fp32, no near ties on this batch)."""
    from apex_tpu_torch.models import GPTModel as PortGPT
    from apex_tpu_torch.models import gpt_tiny_config as port_tiny
    from apex_tpu_torch.models.generation import generate

    m = PortGPT(port_tiny(), device="cpu")
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in jax_side["sd"].items()})
    want = generate(m, torch.from_numpy(jax_side["ids"][:, :8]), 4).numpy()
    for r in range(tp):
        np.testing.assert_allclose(port[tp][r]["tp1_loss"],
                                   jax_side["loss1"], **LOSS_TOL)
        np.testing.assert_array_equal(port[tp][r]["tp1_tokens"], want)
        np.testing.assert_array_equal(port[tp][r]["tokens"], want)


@pytest.mark.parametrize("tp", TPS)
def test_tp_grads_unshard_to_tp1(port, jax_side, tp):
    """The ranks' gradients put back together (``unshard_gpt_params``)
    are JAX's tp = 1 gradients."""
    got = unshard_gpt_params([{k: torch.from_numpy(v) for k, v in
                               port[tp][r]["grads"].items()}
                              for r in range(tp)])
    for name, want in jax_side["g1"].items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_gpt_params_matches_jax_layout_and_round_trips(jax_side, tp):
    """Rank r's shard equals the JAX package's ``shard_model_variables``
    shard on a ``tp`` mesh (its ``_interleave_fused`` QKV layout), and
    the shards put back together are the tp = 1 tensors exactly."""
    from apex_tpu.serving.tp import shard_model_variables, tp_mesh

    from apex_tpu_torch.bridge import _gpt_specs
    from apex_tpu_torch.models import GPTModel as PortGPT
    from apex_tpu_torch.models import gpt_tiny_config as port_tiny
    from apex_tpu_torch.transformer.tensor_parallel.layers import (
        partition_specs)

    full = {k: torch.from_numpy(v) for k, v in jax_side["sd"].items()}
    # the bridge's split table is the model's own layout
    assert _gpt_specs(full) == partition_specs(
        PortGPT(port_tiny(), device="cpu"))
    shards = [shard_gpt_params(full, tp, r) for r in range(tp)]
    back = unshard_gpt_params(shards)
    for name, t in full.items():
        assert torch.equal(back[name], t), name
    mesh = tp_mesh(tp)
    m = GPTModel(gpt_tiny_config(tensor_parallel_size=tp))
    jv, _ = shard_model_variables(m, jax_side["v1"], mesh)
    for r in range(tp):
        dev = mesh.devices.flat[r]
        leaves = jax.tree.map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == dev)), jv)
        want = gpt_params_from_flax(leaves)
        for name, t in want.items():
            np.testing.assert_array_equal(shards[r][name].numpy(),
                                          t.numpy(), err_msg=name)
