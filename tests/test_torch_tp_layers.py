"""The port's tensor-parallel regions, layers and vocab-parallel loss over
spawned ``gloo`` ranks, against the JAX package's on the forced CPU mesh.

The cases of ``tests/test_tp_layers.py``: the seven model- and
sequence-parallel regions (forward and the input's gradient under a
per-rank cotangent), ``ColumnParallelLinear`` (``gather_output`` both
ways), ``RowParallelLinear`` (``input_is_parallel`` both ways), the
column-into-row MLP, the sequence-parallel pair, ``VocabParallelEmbedding``
and its tied head, ``vocab_parallel_cross_entropy`` at smoothing 0 and 0.1
with its gradient, at tp 2 and 4. Both sides get the same per-rank inputs
and weight shards (``_torch_tp_worker.layer_inputs``); the JAX side runs
every case in one ``shard_map`` over the ``model`` axis. Also the RNG
tracker, ``broadcast_data``, ``checkpoint`` and the collectives on the
port's side. The ranks of each tp run every case once, in a module
fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from _torch_tp_worker import LAYERS, REGIONS, layer_inputs, layers_worker
from apex_tpu.mesh import MODEL_AXIS
from apex_tpu_torch.parallel import run_ranks

TPS = (2, 4)
#: forward values and gradients (the JAX tests' bars: 1e-5 and 1e-4)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def port():
    """tp -> every rank's results (one spawn of tp ranks each)."""
    return {tp: run_ranks(layers_worker, tp, threads=1, timeout=120)
            for tp in TPS}


def _blk(a, dim, tp):
    """The per-rank blocks of ``a`` along ``dim``, stacked."""
    return np.stack(np.split(a, tp, axis=dim))


def _rep(a, tp):
    return np.stack([a] * tp)


def _jax_all(tp):
    """Every case on the JAX side: ``{case: [out, grads...]}`` with a
    leading rank axis."""
    from apex_tpu.transformer import parallel_state
    from apex_tpu.transformer.tensor_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
        mappings as jm, vocab_parallel_cross_entropy)

    inp = layer_inputs(tp)
    full, mine = inp["x_full"], inp["x_rank"]
    ax = MODEL_AXIS
    per_rank = dict(
        copy=(_rep(full, tp), inp["g_full"]),
        reduce=(mine, inp["g_full"]),
        scatter=(_rep(full, tp), inp["g_block"]),
        gather=(np.stack([_blk(m, -1, tp)[r] for r, m in enumerate(mine)]),
                inp["g_full"]),
        sp_scatter=(_rep(full, tp), inp["g_rows"]),
        sp_gather=(np.stack([_blk(m, 0, tp)[r] for r, m in enumerate(mine)]),
                   inp["g_full"]),
        sp_gather_split=(np.stack([_blk(m, 0, tp)[r]
                                   for r, m in enumerate(mine)]),
                         inp["g_full"]),
        sp_reduce_scatter=(mine, inp["g_rows"]))
    # the axis named at each call: the custom VJPs take it as a
    # non-differentiable argument
    regions = dict(
        copy=lambda x: jm.copy_to_tensor_model_parallel_region(x, ax),
        reduce=lambda x: jm.reduce_from_tensor_model_parallel_region(x, ax),
        scatter=lambda x: jm.scatter_to_tensor_model_parallel_region(x, ax),
        gather=lambda x: jm.gather_from_tensor_model_parallel_region(x, ax),
        sp_scatter=lambda x: jm.scatter_to_sequence_parallel_region(x, ax),
        sp_gather=lambda x: jm.gather_from_sequence_parallel_region(
            x, ax, True),
        sp_gather_split=lambda x: jm.gather_from_sequence_parallel_region(
            x, ax, False),
        sp_reduce_scatter=lambda x:
        jm.reduce_scatter_to_sequence_parallel_region(x, ax))
    lay = dict(
        column_gather=(ColumnParallelLinear(16, 32, gather_output=True,
                                            world_size=tp),
                       _rep(inp["lin_x"], tp),
                       dict(weight=_blk(inp["col_w"], 0, tp),
                            bias=_blk(inp["col_b"], 0, tp)),
                       _rep(inp["col_g"], tp)),
        column_local=(ColumnParallelLinear(16, 32, gather_output=False,
                                           world_size=tp),
                      _rep(inp["lin_x"], tp),
                      dict(weight=_blk(inp["col_w"], 0, tp),
                           bias=_blk(inp["col_b"], 0, tp)),
                      _blk(inp["col_g"], 1, tp)),
        row_scatter=(RowParallelLinear(16, 8, input_is_parallel=False,
                                       world_size=tp),
                     _rep(inp["lin_x"], tp),
                     dict(weight=_blk(inp["row_w"], 1, tp),
                          bias=_rep(inp["row_b"], tp)),
                     _rep(inp["row_g"], tp)),
        row_parallel=(RowParallelLinear(16, 8, input_is_parallel=True,
                                        world_size=tp),
                      _blk(inp["lin_x"], 1, tp),
                      dict(weight=_blk(inp["row_w"], 1, tp),
                           bias=_rep(inp["row_b"], tp)),
                      _rep(inp["row_g"], tp)))
    pairs = dict(
        mlp=(False, _rep(inp["mlp_x"], tp), _blk(inp["mlp_w1"], 0, tp),
             _blk(inp["mlp_w2"], 1, tp), _rep(inp["mlp_g"], tp)),
        sequence_parallel=(True, _blk(inp["sp_x"], 0, tp),
                           _blk(inp["sp_w1"], 0, tp),
                           _blk(inp["sp_w2"], 1, tp),
                           _blk(inp["sp_g"], 0, tp)))
    emb = VocabParallelEmbedding(32, 8, world_size=tp)
    args = dict(
        regions=per_rank, layers={k: v[1:] for k, v in lay.items()},
        pairs={k: v[1:] for k, v in pairs.items()},
        emb=(_blk(inp["emb_w"], 0, tp), _rep(inp["emb_g"], tp),
             _rep(inp["att_x"], tp), _blk(inp["att_g"], 1, tp)),
        ce=_blk(inp["ce_logits"], 1, tp))
    ids, target = jnp.asarray(inp["ids"]), jnp.asarray(inp["ce_target"])

    def vjp(fn, cot, *primals):
        """Output and gradients, a parameter dict's as weight then bias
        (the port's order)."""
        out, back = jax.vjp(fn, *primals)
        grads = []
        for g in back(cot):
            grads += ([g[k] for k in ("weight", "bias") if k in g]
                      if isinstance(g, dict) else [g])
        return [out[None]] + [g[None] for g in grads]

    def body(a):
        a = jax.tree.map(lambda t: t[0], a)
        out = {}
        for name in REGIONS:
            x, g = a["regions"][name]
            out[name] = vjp(regions[name], g, x)
        for name, (x, params, g) in a["layers"].items():
            mod = lay[name][0]
            out[name] = vjp(lambda xx, pp, mod=mod: mod.apply(
                {"params": pp}, xx), g, x, params)
        for name, (x, w1, w2, g) in a["pairs"].items():
            sp = pairs[name][0]
            cpl = ColumnParallelLinear(8, 16, gather_output=False,
                                       bias=False, world_size=tp,
                                       sequence_parallel_enabled=sp)
            rpl = RowParallelLinear(16, 8, input_is_parallel=True,
                                    bias=False, world_size=tp,
                                    sequence_parallel_enabled=sp)

            def f(xx, a1, a2, sp=sp, cpl=cpl, rpl=rpl):
                h = cpl.apply({"params": {"weight": a1}}, xx)
                if not sp:
                    h = jax.nn.gelu(h, approximate=True)
                return rpl.apply({"params": {"weight": a2}}, h)

            out[name] = vjp(f, g, x, w1, w2)
        w, g_emb, x_att, g_att = a["emb"]
        out["embedding"] = vjp(
            lambda ww: emb.apply({"params": {"weight": ww}}, ids), g_emb, w)
        out["attend"] = vjp(
            lambda xx, ww: emb.apply({"params": {"weight": ww}}, xx,
                                     method=emb.attend), g_att, x_att, w)
        for smoothing in (0.0, 0.1):
            out[f"ce{smoothing}"] = vjp(
                lambda lg, s=smoothing: vocab_parallel_cross_entropy(
                    lg, target, s), jnp.ones(6, jnp.float32), a["ce"])
        return out

    mesh = parallel_state.initialize_model_parallel(tp)
    try:
        # check_vma=False: the mappings' custom VJPs carry the reference's
        # collective pairs (tests/test_tp_layers.py runs them so too)
        run = jax.shard_map(body, mesh=mesh, in_specs=P(ax), out_specs=P(ax),
                            check_vma=False)
        return jax.tree.map(np.asarray, run(args))
    finally:
        parallel_state.destroy_model_parallel()


@pytest.fixture(scope="module")
def jax_side():
    return {tp: _jax_all(tp) for tp in TPS}


def _check(port_case, jax_case, rank):
    """Output at the forward bar, every gradient at the gradient bar."""
    np.testing.assert_allclose(port_case[0], jax_case[0][rank], **FWD_TOL)
    assert len(port_case) == len(jax_case)
    for got, want in zip(port_case[1:], jax_case[1:]):
        np.testing.assert_allclose(got, want[rank], **GRAD_TOL)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("region", REGIONS)
def test_region_matches_jax(port, jax_side, tp, region):
    for r in range(tp):
        _check(port[tp][r]["regions"][region], jax_side[tp][region], r)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("case", LAYERS)
def test_layer_matches_jax(port, jax_side, tp, case):
    for r in range(tp):
        _check(port[tp][r]["layers"][case], jax_side[tp][case], r)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vocab_parallel_cross_entropy_matches_jax(port, jax_side, tp,
                                                  smoothing):
    for r in range(tp):
        _check(port[tp][r]["ce"][smoothing], jax_side[tp][f"ce{smoothing}"],
               r)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vocab_parallel_cross_entropy_matches_plain(port, smoothing):
    """The loss against plain log-softmax on the gathered logits, with the
    reference's smoothing rescale ``vocab / (vocab - 1)``."""
    inp = layer_inputs(4)
    lg, tg = inp["ce_logits"], inp["ce_target"]
    logp = lg - np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(
        -1, keepdims=True)) - lg.max(-1, keepdims=True)
    nll = -np.take_along_axis(logp, tg[:, None], 1)[:, 0]
    adj = smoothing * 32 / 31
    want = (1 - adj) * nll - adj * logp.mean(-1)
    for r in range(4):
        np.testing.assert_allclose(port[4][r]["ce"][smoothing][0], want,
                                   **FWD_TOL)


@pytest.mark.parametrize("tp", TPS)
def test_rng_tracker_decorrelates_ranks_and_round_trips(port, tp):
    misc = [port[tp][r]["misc"] for r in range(tp)]
    mp = {tuple(m["mp_draw"].round(6)) for m in misc}
    assert len(mp) == tp                     # the model-parallel stream
    for m in misc:
        np.testing.assert_array_equal(m["default_draw"],
                                      misc[0]["default_draw"])
        np.testing.assert_array_equal(m["replay"], m["mp_draw"])
        # the checkpointed block replays its dropout draws exactly
        np.testing.assert_array_equal(m["g_ckpt"], m["g_plain"])


@pytest.mark.parametrize("tp", TPS)
def test_broadcast_data_and_collectives(port, tp):
    v = [np.arange(6, dtype=np.float32).reshape(2, 3) * (r + 1)
         for r in range(tp)]
    scat = sum(np.arange(4.0 * tp, dtype=np.float32).reshape(2 * tp, 2)
               * (r + 1) for r in range(tp))
    for r in range(tp):
        m = port[tp][r]["misc"]
        np.testing.assert_array_equal(m["bcast_x"], np.zeros((2, 3)))
        np.testing.assert_array_equal(m["bcast_n"], np.arange(3))
        c = m["colls"]
        np.testing.assert_allclose(c["sum"], sum(v))
        np.testing.assert_allclose(c["max"], v[-1])
        np.testing.assert_allclose(c["mean"], sum(v) / tp, rtol=1e-6)
        np.testing.assert_array_equal(c["gather0"], np.concatenate(v, 0))
        np.testing.assert_array_equal(c["gather1"], np.concatenate(v, 1))
        np.testing.assert_array_equal(c["scatter"], scat[2 * r:2 * r + 2])
        np.testing.assert_array_equal(c["bcast"], v[-1])
        assert m["backend"] == "gloo"
