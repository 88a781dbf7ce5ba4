"""Port parity: apex_tpu_torch.amp against apex_tpu.amp.

``make_policy`` over O0-O3 and their overrides; ``LossScaler.update`` over
sequences of overflows (hysteresis, growth, both clamps, a static scaler),
state for state; ``initialize`` attaching a scaler only when it is dynamic
or its scale is not 1; the fused skip step with an ``inf`` gradient (and
the steps around it) under FusedAdam, FusedSGD and FusedNovoGrad, against
the JAX optimizers; FusedSGD under a dynamic scaler with ``scale_loss``,
which steps on the still-scaled gradients as the reference's does (its
kernel has no grad-scale slot); ``unscale_and_combine``; O2/O3 refused;
and the amp seam of the ported GPT and BERT. fp32 atol = rtol = 1e-6; the
scaler's state exactly equal.

A fixture resets both packages' module-level amp state after each test, so
that no policy leaks into later tests on the same worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.models import BertForPreTraining as JaxBert
from apex_tpu.models import bert_tiny_config as jax_bert_tiny
from apex_tpu.models.gpt import GPTModel as JaxGPT
from apex_tpu.models.gpt import gpt_tiny_config as jax_gpt_tiny
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedNovoGrad as JaxFusedNovoGrad
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu_torch import amp
from apex_tpu_torch.bridge import bert_params_from_flax, gpt_params_from_flax
from apex_tpu_torch.models import (BertForPreTraining, GPTModel,
                                   bert_tiny_config, gpt_tiny_config)
from apex_tpu_torch.optimizers import FusedAdam, FusedNovoGrad, FusedSGD

TOL = dict(atol=1e-6, rtol=1e-6)
SHAPES = {"a_weight": (6, 5), "b_bias": (5,), "c_kernel": (3, 400)}


@pytest.fixture(autouse=True)
def _reset_amp():
    yield
    jamp._current_policy = None
    jamp._loss_scalers = []
    amp.reset()


def _name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return jnp.dtype(dtype).name


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
@pytest.mark.parametrize("half", ["bfloat16", "float16"])
@pytest.mark.parametrize("overrides", [
    {}, dict(keep_batchnorm_fp32=False, master_weights=True,
             loss_scale=128.0),
    dict(cast_model_type="float16")], ids=["levels", "flags", "cast"])
def test_make_policy_matches_jax(level, half, overrides):
    jkw = {k: (getattr(jnp, v) if k == "cast_model_type" else v)
           for k, v in overrides.items()}
    tkw = {k: (getattr(torch, v) if k == "cast_model_type" else v)
           for k, v in overrides.items()}
    want = jamp.make_policy(level, half_dtype=getattr(jnp, half), **jkw)
    got = amp.make_policy(level, half_dtype=getattr(torch, half), **tkw)
    for f in ("param_dtype", "compute_dtype", "output_dtype"):
        assert _name(getattr(got, f)) == _name(getattr(want, f)), f
    for f in ("opt_level", "keep_norm_fp32", "master_weights", "loss_scale"):
        assert getattr(got, f) == getattr(want, f), f


def test_norm_names_and_bad_level_match_jax():
    from apex_tpu.amp.policy import NORM_NAME_TOKENS, is_norm_param_name

    assert amp.NORM_NAME_TOKENS == NORM_NAME_TOKENS
    for n in ("bn1.weight", "stage0_block0/bn2/bias", "LayerNorm.w",
              "conv1.weight", "fc.bias", "final_norm/weight"):
        assert amp.is_norm_param_name(n) == is_norm_param_name(n), n
    with pytest.raises(ValueError, match="O4") as got:
        amp.make_policy("O4")
    with pytest.raises(ValueError) as want:
        jamp.make_policy("O4")
    assert str(got.value) == str(want.value)


FOUND = [0, 1, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0]


@pytest.mark.parametrize("kw", [
    dict(loss_scale="dynamic", scale_window=3),
    dict(loss_scale="dynamic", scale_window=2, hysteresis=2),
    dict(loss_scale="dynamic", init_scale=2.0 ** 23, scale_window=1,
         max_loss_scale=2.0 ** 24),
    dict(loss_scale="dynamic", init_scale=4.0, scale_window=50,
         min_loss_scale=1.0),
    dict(loss_scale=128.0, scale_window=2),
], ids=["growth", "hysteresis", "max_clamp", "min_clamp", "static"])
def test_loss_scaler_update_sequence_matches_jax(kw):
    js, ts = jamp.LossScaler(**kw), amp.LossScaler(**kw)
    jst, tst = js.state, ts.state
    for i, f in enumerate(FOUND):
        jst = js.update(jst, jnp.asarray(float(f)))
        tst = ts.update(tst, torch.tensor(float(f)))
        for field in ("scale", "growth_tracker", "dynamic",
                      "hysteresis_tracker"):
            assert getattr(tst, field).item() == \
                np.asarray(getattr(jst, field)).item(), (i, field)
    assert tst.scale.dtype == torch.float32
    assert tst.growth_tracker.dtype == torch.int32


def _jax_params():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _port_module(params):
    return torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(
        v.copy())) for k, v in params.items()})


OPTS = {"adam": (JaxFusedAdam, FusedAdam, dict(lr=1e-2, weight_decay=0.01)),
        "sgd": (JaxFusedSGD, FusedSGD, dict(lr=0.1, momentum=0.9,
                                             weight_decay=1e-4)),
        "novograd": (JaxFusedNovoGrad, FusedNovoGrad,
                     dict(lr=1e-2, weight_decay=1e-3))}


def _both(kind, **amp_kw):
    jcls, tcls, kw = OPTS[kind]
    params = _jax_params()
    jopt = jcls({k: jnp.asarray(v) for k, v in params.items()}, **kw)
    module = _port_module(params)
    opt = tcls(list(module.named_parameters()), **kw)
    _, jopt = jamp.initialize({k: jnp.asarray(v) for k, v in params.items()},
                              jopt, **_jax_kw(amp_kw))
    _, opt = amp.initialize(module, opt, **amp_kw)
    return jopt, opt, module


def _jax_kw(kw):
    return {k: (getattr(jnp, str(v).split(".")[-1]) if k == "half_dtype"
                else v) for k, v in kw.items()}


@pytest.mark.parametrize("level,half,loss_scale,attached", [
    ("O0", torch.bfloat16, None, False),
    ("O0", torch.bfloat16, 128.0, True),
    ("O1", torch.bfloat16, None, False),
    ("O1", torch.float16, None, True),
    ("O1", torch.bfloat16, "dynamic", True),
])
def test_initialize_attaches_a_scaler_only_when_it_acts(level, half,
                                                        loss_scale, attached):
    jopt, opt, _ = _both("sgd", opt_level=level, half_dtype=half,
                         loss_scale=loss_scale)
    assert (jopt._amp_scaler is not None) == attached
    assert (opt._amp_scaler is not None) == attached
    assert amp.current_policy().opt_level == level
    assert opt._amp_require_noop is False


def _grads(step, poison=False):
    rng = np.random.default_rng(10 + step)
    g = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in SHAPES.items()}
    if poison:
        g["b_bias"][2] = np.inf
    return g


@pytest.mark.parametrize("kind", ["adam", "sgd", "novograd"])
def test_fused_skip_step_matches_jax(kind):
    jopt, opt, module = _both(kind, opt_level="O1", half_dtype=torch.float16)
    for i, poison in enumerate((False, True, False)):
        g = _grads(i, poison)
        before = opt.master.clone()
        bufs = {k: v.clone() for k, v in opt.state.items()}
        count = int(opt.step_count)
        jp = jopt.step({k: jnp.asarray(v) for k, v in g.items()})
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       **TOL, err_msg=f"{k} step {i}")
        assert int(opt.step_count) == int(jopt.step_count)
        js, ts = jopt._amp_scaler.state, opt._amp_scaler.state
        assert ts.scale.item() == float(js.scale)
        assert ts.growth_tracker.item() == int(js.growth_tracker)
        if poison:
            assert torch.equal(opt.master, before)
            for k, v in bufs.items():
                assert torch.equal(opt.state[k], v), k
            assert int(opt.step_count) == count
            assert ts.scale.item() == 2.0 ** 15


def test_fused_sgd_under_scale_loss_steps_on_scaled_grads_as_jax():
    """The reference's FusedSGD passes no grad scale to its kernel, so a
    loss scaled by ``amp.scale_loss`` moves the parameters by the scaled
    gradient (x 2^16 at the first step); the port keeps that."""
    jopt, opt, module = _both("sgd", opt_level="O1",
                              half_dtype=torch.float16)
    params = _jax_params()
    w = _grads(7)

    def jloss(p):
        loss = sum(jnp.sum(p[k] * w[k]) for k in SHAPES) * 1e-6
        with jamp.scale_loss(loss, jopt) as scaled:
            return scaled

    jg = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
    jp = jopt.step(jg)
    loss = sum((p * torch.from_numpy(w[k])).sum()
               for k, p in module.named_parameters()) * 1e-6
    with amp.scale_loss(loss, opt) as scaled:
        scaled.backward()
    opt.step()
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   **TOL, err_msg=k)
        # first step: momentum = raw (scaled) gradient
        step = (params[k] - p.detach().numpy()) / 0.1
        want = 2.0 ** 16 * 1e-6 * w[k] + 1e-4 * params[k]
        np.testing.assert_allclose(step, want, rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def test_unscale_and_combine_matches_jax():
    jopt, opt, module = _both("sgd", opt_level="O1",
                              half_dtype=torch.float16, num_losses=2)
    assert jopt._amp_require_noop and opt._amp_require_noop
    assert opt._amp_scaler is None and jopt._amp_scaler is None
    for step, poison in enumerate((False, True, False)):
        scales = [s.state.scale.item() for s in amp.loss_scalers()]
        gl = [{k: v * np.float32(sc) for k, v in _grads(2 * step + j,
               poison and j == 1).items()} for j, sc in enumerate(scales)]
        jt, jn = jamp.unscale_and_combine(
            [{k: jnp.asarray(v) for k, v in g.items()} for g in gl])
        tt, tn = amp.unscale_and_combine(
            [{k: torch.from_numpy(v) for k, v in g.items()} for g in gl])
        assert tn.item() == float(jn) == float(poison)
        for k in SHAPES:
            np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                       **TOL, err_msg=k)
        for js, ts in zip(jamp._loss_scalers, amp.loss_scalers()):
            assert ts.state.scale.item() == float(js.state.scale)
    with pytest.raises(RuntimeError, match="unscale_and_combine"):
        opt.step()
    with pytest.raises(RuntimeError, match="unscale_and_combine"):
        jopt.step({k: jnp.asarray(v) for k, v in _grads(0).items()})
    for k, p in module.named_parameters():
        p.grad = tt[k]
    opt.step(noop=tn)
    assert int(opt.step_count) == 1


@pytest.mark.parametrize("level,kw", [
    ("O2", {}), ("O3", {}), ("O1", dict(cast_model_type=torch.float16))])
def test_half_model_levels_raise_naming_the_roadmap_item(level, kw):
    module = _port_module(_jax_params())
    with pytest.raises(NotImplementedError, match="item 11: O2/O3"):
        amp.initialize(module, opt_level=level, **kw)
    assert amp.current_policy() is None


def test_amp_state_dict_round_trip_and_master_params():
    jopt, opt, module = _both("adam", opt_level="O1",
                              half_dtype=torch.float16)
    for i, poison in enumerate((True, True, False)):
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(_grads(i, poison)[k])
        opt.step()
    sd = amp.state_dict()
    assert sd["loss_scaler0"]["scale"].item() == 2.0 ** 14
    amp.initialize(module, opt, opt_level="O1", half_dtype=torch.float16)
    assert amp.loss_scalers()[0].state.scale.item() == 2.0 ** 16
    amp.load_state_dict(sd)
    st = amp.loss_scalers()[0].state
    assert st.scale.item() == 2.0 ** 14 and st.growth_tracker.item() == 1
    mp = amp.master_params(opt)
    for k, p in module.named_parameters():
        assert torch.equal(mp[k], p.detach())


def test_disabled_amp_returns_inputs_and_sets_nothing():
    module = _port_module(_jax_params())
    assert amp.initialize(module, enabled=False) is module
    assert amp.current_policy() is None
    with amp.scale_loss(torch.tensor(3.0)) as s:
        assert s.item() == 3.0


def _gpt_pair():
    jm = JaxGPT(jax_gpt_tiny())
    ids = np.random.default_rng(0).integers(0, 128, (2, 9)).astype(np.int32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    tm = GPTModel(gpt_tiny_config(), device="cpu")
    tm.load_state_dict(gpt_params_from_flax(
        jax.tree.map(np.asarray, variables)))

    def jfwd():
        return jm.apply(variables, jnp.asarray(ids))

    def tfwd():
        return tm(torch.from_numpy(ids))
    return variables, tm, jfwd, tfwd


def _bert_pair():
    cfg = jax_bert_tiny()
    jm = JaxBert(cfg)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    tt = np.zeros_like(ids)
    mask = np.ones_like(ids)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                        jnp.asarray(tt), jnp.asarray(mask))
    tm = BertForPreTraining(bert_tiny_config(), device="cpu")
    tm.load_state_dict(bert_params_from_flax(
        jax.tree.map(np.asarray, variables["params"])))
    targs = [torch.from_numpy(a) for a in (ids, tt, mask)]

    def jfwd():
        return jm.apply(variables, jnp.asarray(ids), jnp.asarray(tt),
                        jnp.asarray(mask))[0]

    def tfwd():
        return tm(*targs)[0]
    return variables, tm, jfwd, tfwd


@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_o1_seam_sets_the_models_compute_dtype_as_jax(model):
    variables, tm, jfwd, tfwd = {"gpt": _gpt_pair, "bert": _bert_pair}[model]()
    with torch.no_grad():
        off_t = tfwd()
    off_j = jfwd()
    assert _name(off_t.dtype) == _name(off_j.dtype) == "float32"
    jamp.initialize(variables, opt_level="O1")
    amp.initialize(tm, opt_level="O1")
    with torch.no_grad():
        on_t = tfwd()
    on_j = jfwd()
    assert _name(on_t.dtype) == _name(on_j.dtype) == "bfloat16"
    # one bf16 rounding per op on either side: a few bf16 ulps of the
    # logits' scale
    scale = float(np.abs(np.asarray(off_j)).max())
    np.testing.assert_allclose(on_t.float().numpy(),
                               np.asarray(on_j, np.float32),
                               atol=0.05 * scale, rtol=0.05)


def test_scope_sets_and_restores_the_amp_state():
    module = _port_module(_jax_params())
    amp.initialize(module, opt_level="O1", half_dtype=torch.float16)
    o1 = amp.active_state()
    assert amp.resolve_compute_dtype(torch.float32) == torch.float16
    with amp.scope():
        assert amp.current_policy() is None and amp.loss_scalers() == ()
        assert amp.resolve_compute_dtype(torch.float32) == torch.float32
        with amp.scope(o1):
            assert amp.active_state() == o1
        assert amp.current_policy() is None
    assert amp.active_state() == o1
    amp.reset()
    assert amp.current_policy() is None and amp.loss_scalers() == ()
