"""Port parity: amp O2/O3, the half model copies beside the fp32 master.

``amp.initialize`` at O2, O3 and with ``cast_model_type`` casts the same
parameter set as ``apex_tpu.amp.initialize`` (tiny BERT and the ImageNet
example's ``resnet_tiny``, the default norm predicate and a custom
``keep_fp32_predicate``; flax paths mapped to the port's names through the
bridges). FusedAdam, FusedLAMB, FusedSGD and FusedNovoGrad under O2 (a bf16
and a norm tensor): three steps give JAX's fp32 master (atol = rtol = 1e-6,
as ``tests/test_torch_optim.py``) and half copies bit-equal to the params
JAX's step returns; ``state_dict`` round trips refresh the copies. The fp16
dynamic cases of ``tests/test_amp.py:44-127`` (a skip without a count, the
backoff, growth, the fused unscale) against the JAX optimizer. The ResNet
O0/O1/O2 drift check of ``tests/test_examples.py:128-146`` (``resnet_tiny``,
drift below 0.25 nats, each curve falling), and tiny BERT under O2 with
FusedLAMB (the loss falls over 4 steps, as
``tests/test_bert_model_extended.py:19-51``).
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.models import BertForPreTraining as JaxBert
from apex_tpu.models import bert_tiny_config as jax_bert_tiny
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.optimizers import FusedNovoGrad as JaxFusedNovoGrad
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu_torch import amp
from apex_tpu_torch.bridge import (bert_params_from_flax,
                                   resnet_params_from_flax)
from apex_tpu_torch.examples.imagenet import main_amp as pm
from apex_tpu_torch.models import (BertForPreTraining, bert_pretrain_loss_fn,
                                   bert_tiny_config, synthetic_batch)
from apex_tpu_torch.optimizers import (FusedAdam, FusedLAMB, FusedNovoGrad,
                                       FusedSGD)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-6, rtol=1e-6)
# sorted, so JAX's dict order and the port's insertion order agree
SHAPES = {"a_weight": (6, 5), "b_bias": (5,), "c_kernel": (3, 400),
          "d_norm_weight": (7,)}


@pytest.fixture(autouse=True)
def _reset_amp():
    yield
    jamp._current_policy = None
    jamp._loss_scalers = []
    amp.reset()


def _jdt(dtype):
    return getattr(jnp, str(dtype).split(".")[-1])


def _is_half(leaf) -> bool:
    return jnp.dtype(leaf.dtype) != jnp.float32


# --- the cast parameter set ------------------------------------------------

def _zeros(init, *args):
    """The parameter tree ``init`` would make, as numpy zeros: its shapes
    and dtypes by ``jax.eval_shape``, with nothing compiled."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        shapes["params"])


def _jax_bert():
    ids = jnp.ones((1, 8), jnp.int32)
    return _zeros(JaxBert(jax_bert_tiny()).init, ids, ids, ids)


def _jax_resnet():
    name = "example_imagenet_amp_o2"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples/imagenet/main_amp.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod   # flax dataclass processing looks it up
    spec.loader.exec_module(mod)
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    return _zeros(functools.partial(mod.resnet_tiny().init, train=True), x)


MODELS = {
    "bert": (_jax_bert, bert_params_from_flax,
             lambda: BertForPreTraining(bert_tiny_config(), device="cpu")),
    "resnet": (_jax_resnet, lambda t: resnet_params_from_flax({"params": t}),
               lambda: pm.resnet_tiny(device="cpu")),
}


@pytest.fixture(scope="module")
def jax_trees():
    return {k: v[0]() for k, v in MODELS.items()}


@pytest.mark.parametrize("kw", [
    dict(opt_level="O2"), dict(opt_level="O3"),
    dict(opt_level="O1", cast_model_type=torch.float16),
    dict(opt_level="O2", half_dtype=torch.float16,
         keep_fp32_predicate=lambda n: "bias" in n)],
    ids=["O2", "O3", "O1_cast_fp16", "O2_fp16_bias_kept"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_initialize_casts_the_parameter_set_jax_casts(model, kw, jax_trees):
    _, bridge, build = MODELS[model]
    jkw = {k: (_jdt(v) if isinstance(v, torch.dtype) else v)
           for k, v in kw.items()}
    cast = jamp.initialize(jax_trees[model], **jkw)
    # the JAX dtypes carried to the port's names: 1 where half
    want = bridge(jax.tree.map(lambda l: np.full(l.shape, _is_half(l),
                                                 np.float32), cast))
    module = build()
    assert amp.initialize(module, **kw) is module
    half = kw.get("cast_model_type", kw.get("half_dtype", torch.bfloat16))
    for name, p in module.named_parameters():
        assert p.dtype == (half if want[name].all() else torch.float32), name
        assert want[name].all() or not want[name].any(), name
    assert any(p.dtype == half for p in module.parameters())
    # buffers (the norms' running statistics) stay fp32
    assert all(b.dtype == torch.float32 for b in module.buffers()
               if b.is_floating_point())


# --- O2 steps against the JAX optimizers ----------------------------------

OPTS = {"adam": (JaxFusedAdam, FusedAdam, dict(lr=1e-2, weight_decay=0.01)),
        "lamb": (JaxFusedLAMB, FusedLAMB, dict(lr=1e-2, weight_decay=0.01)),
        "sgd": (JaxFusedSGD, FusedSGD, dict(lr=0.1, momentum=0.9,
                                             weight_decay=1e-4)),
        "novograd": (JaxFusedNovoGrad, FusedNovoGrad,
                     dict(lr=1e-2, weight_decay=1e-3))}


def _params(shapes=SHAPES, fill=None):
    rng = np.random.default_rng(0)
    return {k: (np.full(s, fill, np.float32) if fill is not None
                else rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}


def _both(kind, params, opt_kw=None, **amp_kw):
    """The JAX and the port optimizer over the same fp32 parameters, both
    through ``amp.initialize(**amp_kw)``: ``(jax params, jopt, module,
    opt)``."""
    jcls, tcls, kw = OPTS[kind]
    kw = kw if opt_kw is None else opt_kw
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = jcls(jp, **kw)
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(
        torch.from_numpy(v.copy())) for k, v in params.items()})
    opt = tcls(list(module.named_parameters()), **kw)
    jkw = {k: (_jdt(v) if isinstance(v, torch.dtype) else v)
           for k, v in amp_kw.items()}
    jp, jopt = jamp.initialize(jp, jopt, **jkw)
    assert amp.initialize(module, opt, **amp_kw) == (module, opt)
    return jp, jopt, module, opt


def _grads(params_dtypes, step, poison=False, scale=1.0):
    """numpy fp32 gradients, and both sides' in each parameter's dtype
    (JAX's ``jax.grad`` of half parameters is half)."""
    rng = np.random.default_rng(10 + step)
    g = {k: (rng.standard_normal(s) * scale).astype(np.float32)
         for k, s in SHAPES.items()}
    if poison:
        g["b_bias"][2] = np.inf
    jg = {k: jnp.asarray(v).astype(params_dtypes[k]) for k, v in g.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    return jg, tg


def _set_grads(module, tg):
    for k, p in module.named_parameters():
        p.grad = tg[k].to(p.dtype)


def _assert_like_jax(module, opt, jopt, jparams, msg):
    got, want = amp.master_params(opt), jamp.master_params(jopt)
    for k, p in module.named_parameters():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=f"{k} {msg}")
        # the half copy: master.to(dtype), bit-equal to JAX's step output
        assert p.dtype == {jnp.bfloat16: torch.bfloat16,
                           jnp.float16: torch.float16,
                           jnp.float32: torch.float32}[
                               jnp.dtype(jparams[k].dtype).type], k
        assert torch.equal(p.detach(), got[k].to(p.dtype)), k
        if p.dtype != torch.float32:    # an fp32 tensor IS its master view
            np.testing.assert_array_equal(
                p.detach().float().numpy(),
                np.asarray(jparams[k]).astype(np.float32),
                err_msg=f"{k} {msg}")


@pytest.mark.parametrize("kind", sorted(OPTS))
def test_o2_steps_match_jax_master_and_half_copies(kind):
    jp, jopt, module, opt = _both(kind, _params(), opt_level="O2")
    dtypes = {k: v.dtype for k, v in jp.items()}
    assert dtypes["d_norm_weight"] == jnp.float32
    assert module["d_norm_weight"].dtype == torch.float32
    assert module["a_weight"].dtype == torch.bfloat16
    assert opt._amp_scaler is None and jopt._amp_scaler is None
    for i in range(3):
        jg, tg = _grads(dtypes, i)
        jp = jopt.step(jg)
        _set_grads(module, tg)
        opt.step()
        _assert_like_jax(module, opt, jopt, jp, f"step {i}")
        assert int(opt.step_count) == int(jopt.step_count)
    # a load refreshes the half copies from the master it carries
    sd = opt.state_dict()
    with torch.no_grad():
        opt.master.zero_()
        opt.sync_half_params()
    assert (module["a_weight"] == 0).all()
    opt.load_state_dict(sd)
    _assert_like_jax(module, opt, jopt, jp, "after load_state_dict")


def test_norm_gradients_survive_the_half_cast():
    """The half gradients' cast writes only the half tensors' rows: the
    fp32 (norm) tensor's gradient reaches the kernel as it was."""
    _, _, module, opt = _both("sgd", _params(), opt_level="O2")
    _set_grads(module, {k: torch.full(s, 2.0) for k, s in SHAPES.items()})
    opt._gather_grads()
    views = dict(zip(opt.names, opt._grad_views))
    for k in SHAPES:
        seg = opt.grads.view(-1)[opt.spec.row_offsets[opt.names.index(k)]
                                 * 1024:][:views[k].numel()]
        assert (seg == 2.0).all(), k


# --- fp16 dynamic scaling (tests/test_amp.py:44-127) ------------------------

def _w(fill):
    return {"w": np.full((4, 4), fill, np.float32)}


def _fp16_pair():
    jp, jopt, module, opt = _both("adam", _w(1.0), dict(lr=1e-2),
                                  opt_level="O2", half_dtype=torch.float16,
                                  loss_scale="dynamic")
    assert module["w"].dtype == torch.float16
    return jopt, module, opt


def _step_both(jopt, module, opt, g):
    jp = jopt.step({"w": jnp.asarray(g).astype(jnp.float16)})
    module["w"].grad = torch.from_numpy(g).half()
    opt.step()
    return jp


@pytest.mark.parametrize("case", ["skip_without_count", "backoff", "growth",
                                  "unscale"])
def test_fp16_dynamic_cases_match_jax(case):
    jopt, module, opt = _fp16_pair()
    scale0 = opt._amp_scaler.state.scale.item()
    assert scale0 == float(jopt._amp_scaler.state.scale) == 2.0 ** 16
    if case == "growth":
        opt._amp_scaler._scale_window = jopt._amp_scaler._scale_window = 2
    if case == "unscale":
        with amp.scale_loss(torch.tensor(1.0), opt) as sl:
            assert sl.item() == scale0
        grads = [np.full((4, 4), 0.5 * scale0, np.float32)]
    elif case == "growth":
        grads = [np.full((4, 4), 0.5 * scale0, np.float32)] * 3
    else:
        grads = [np.full((4, 4), np.inf, np.float32),
                 np.full((4, 4), 0.5 * scale0 / 2, np.float32)]
    for i, g in enumerate(grads):
        jp = _step_both(jopt, module, opt, g)
        js, ts = jopt._amp_scaler.state, opt._amp_scaler.state
        assert ts.scale.item() == float(js.scale), i
        assert int(opt.step_count) == int(jopt.step_count), i
        _assert_like_jax(module, opt, jopt, {"w": jp["w"]}, f"step {i}")
        if case != "growth" and i == 0 and case != "unscale":
            assert int(opt.step_count) == 0
            assert ts.scale.item() == scale0 / 2
            assert (module["w"] == 1.0).all()
    if case == "growth":
        assert opt._amp_scaler.state.scale.item() == scale0 * 2
    if case == "unscale":
        m, v = 0.1 * 0.5, 0.001 * 0.25
        want = 1.0 - 1e-2 * (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.999))
                                               + 1e-8)
        np.testing.assert_allclose(amp.master_params(opt)["w"].numpy(),
                                   want, rtol=1e-6)


# --- the L1-style drift check and BERT under O2 -----------------------------

def _quiet(*a, **k):
    pass


def test_resnet_opt_levels_drift_within_half_precision():
    curves = {}
    for lvl in ("O0", "O1", "O2", "O3"):
        curves[lvl] = pm.run_training(
            pm.resnet_tiny(device="cpu"), steps=6, batch_size=8,
            image_size=16, opt_level=lvl, lr=0.05, device="cpu",
            verbose=_quiet)
        amp.reset()
    o0 = np.asarray(curves["O0"])
    for lvl in ("O1", "O2", "O3"):
        drift = np.max(np.abs(np.asarray(curves[lvl]) - o0))
        assert drift < 0.25, (lvl, curves[lvl], curves["O0"])
        assert curves[lvl][-1] < curves[lvl][0], (lvl, curves[lvl])


def test_bert_tiny_o2_lamb_loss_falls():
    cfg = bert_tiny_config()
    model = BertForPreTraining(cfg, device="cpu")
    batch = synthetic_batch(np.random.default_rng(0), cfg, 4, 32,
                            device="cpu")
    opt = FusedLAMB(model.named_parameters(), lr=1e-3)
    model, opt = amp.initialize(model, opt, opt_level="O2")
    for name, p in model.named_parameters():
        want = torch.float32 if amp.is_norm_param_name(name) \
            else torch.bfloat16
        assert p.dtype == want, name
    assert model.word_embeddings.dtype == torch.bfloat16
    losses = []
    for i in range(4):
        opt.zero_grad()
        loss = bert_pretrain_loss_fn(model, batch, i)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses
    master = amp.master_params(opt)
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), master[name].to(p.dtype)), name
    assert model.layers[0].attention.qkv_weight.dtype == torch.bfloat16
