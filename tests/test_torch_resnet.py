"""Port parity: the ImageNet example's ResNet, SyncBatchNorm, the DDP
facade and the training loop against ``examples/imagenet/main_amp.py``.

The JAX example is loaded by path, as ``tests/test_examples.py`` loads it.
A flax ``resnet_tiny`` init (seed 0, on the example's synthetic batch) goes
through ``bridge.resnet_params_from_flax`` into the port; the same numpy
images (NHWC there, transposed to NCHW here) then give, on both sides: the
logits in train and eval mode (fp32, atol = rtol = 1e-5), the running
statistics after a training forward, every gradient of the loss (atol
1e-5, rtol 1e-4: the same formula, summed in another order), and the
losses of ``run_training`` over 4 FusedSGD steps under O0 (1e-5 relative)
and under O1 bf16 (atol 0.02 nats + 2e-2 relative: both sides round every
convolution's output, each norm's output and the residual sums to bf16, in
other orders; the first losses differ by 0.2%, and SGD at lr 0.05 on a
memorized batch carries that into ~0.01 nats by the fourth step). SyncBatchNorm alone
against the reference's in fp32 and bf16, ``convert_syncbn_model``, the
DDP facade, the O1 seam, and ResNet-50's sizes.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.parallel import SyncBatchNorm as JaxSyncBatchNorm
from apex_tpu_torch import amp
from apex_tpu_torch.bridge import resnet_params_from_flax
from apex_tpu_torch.examples.imagenet import main_amp as pm
from apex_tpu_torch.ops import flat_buffer
from apex_tpu_torch.parallel import (DistributedDataParallel, SyncBatchNorm,
                                     convert_syncbn_model)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, IMG, CLASSES = 8, 16, 10
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _load_example():
    name = "example_imagenet_port_parity"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples/imagenet/main_amp.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod   # flax dataclass processing looks it up
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _reset_amp():
    yield
    jamp._current_policy = None
    jamp._loss_scalers = []
    amp.reset()


@pytest.fixture(scope="module")
def ref():
    ex = _load_example()
    images, labels = ex.synthetic_batch(np.random.default_rng(0), B, IMG,
                                        CLASSES)
    model = ex.resnet_tiny()
    variables = model.init(jax.random.PRNGKey(0), images, train=True)

    def loss_fn(p, bs, x, y):
        logits, updates = model.apply({"params": p, "batch_stats": bs}, x,
                                      train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, y[:, None], axis=1).mean()
        return nll, (logits, updates["batch_stats"])

    (loss, (logits, stats)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"],
                               variables["batch_stats"], images, labels)
    eval_logits = model.apply(variables, images, train=False)
    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    return dict(ex=ex, variables=np_tree(variables),
                images=np.asarray(images), labels=np.asarray(labels),
                loss=float(loss), logits=np.asarray(logits),
                stats=np_tree(stats), grads=np_tree(grads),
                eval_logits=np.asarray(eval_logits))


def _port(ref):
    tm = pm.resnet_tiny(device="cpu")
    tm.load_state_dict(resnet_params_from_flax(ref["variables"]))
    x = torch.from_numpy(np.array(ref["images"])).permute(0, 3, 1, 2)
    x = x.contiguous()
    return tm, x, torch.from_numpy(ref["labels"].astype(np.int64))


def test_bridge_is_total_and_refuses_strangers(ref):
    sd = resnet_params_from_flax(ref["variables"])
    tm = pm.resnet_tiny(device="cpu")
    assert set(sd) == set(tm.state_dict())
    assert len(sd) == len(jax.tree.leaves(ref["variables"]))
    k = ref["variables"]["params"]["stage1_block0"]["Conv_1"]["kernel"]
    np.testing.assert_array_equal(
        sd["stage1_block0.conv2.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc.weight"].numpy(),
                                  ref["variables"]["params"]["fc"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["stage0_block0.downsample_bn.running_var"].numpy(),
        ref["variables"]["batch_stats"]["stage0_block0"]["downsample_bn"][
            "var"])
    for bad in ({"params": {"stray": {"kernel": np.zeros(3)}}},
                {"params": {"stage0_block0": {"Conv_3": {
                    "kernel": np.zeros((1, 1, 1, 1))}}}},
                {"params": {"fc": {"scale": np.zeros(3)}}},
                {"params": {}, "cache": {"x": np.zeros(1)}}):
        with pytest.raises(KeyError):
            resnet_params_from_flax(bad)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_matches_jax(ref, train):
    tm, x, _ = _port(ref)
    tm.train(train)
    with torch.no_grad():
        got = tm(x)
    want = ref["logits"] if train else ref["eval_logits"]
    assert got.dtype == torch.float32 and got.shape == (B, CLASSES)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_gradients_and_running_stats_match_jax(ref):
    tm, x, y = _port(ref)
    tm.train()
    loss = pm.nll_loss(tm(x), y)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], **TOL)
    want = resnet_params_from_flax({"params": ref["grads"]})
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   **GRAD_TOL, err_msg=name)
    stats = resnet_params_from_flax({"batch_stats": ref["stats"]})
    buffers = dict(tm.named_buffers())
    assert set(stats) == set(buffers)
    for name, want_t in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want_t.numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_sync_batchnorm_matches_jax(dtype, train):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 5, 6, 7)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(7)).astype(np.float32)
    b = (0.1 * rng.standard_normal(7)).astype(np.float32)
    rm = (0.1 * rng.standard_normal(7)).astype(np.float32)
    rv = (1 + 0.1 * rng.random(7)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    bn = JaxSyncBatchNorm(axis_name=None)
    variables = {"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                 "batch_stats": {"mean": jnp.asarray(rm),
                                 "var": jnp.asarray(rv)}}

    def f(xx, ww, bb):
        v = {"params": {"weight": ww, "bias": bb},
             "batch_stats": variables["batch_stats"]}
        return bn.apply(v, xx, use_running_average=not train,
                        mutable=["batch_stats"])

    (jy, jupd) = f(jx, jnp.asarray(w), jnp.asarray(b))
    _, vjp = jax.vjp(lambda *a: f(*a)[0], jx, jnp.asarray(w),
                     jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(dy).astype(jy.dtype))

    sbn = SyncBatchNorm(7)
    with torch.no_grad():
        sbn.weight.copy_(torch.from_numpy(w))
        sbn.bias.copy_(torch.from_numpy(b))
        sbn.running_mean.copy_(torch.from_numpy(rm))
        sbn.running_var.copy_(torch.from_numpy(rv))
    sbn.train(train)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt).requires_grad_()
    ty = sbn(tx)
    ty.backward(torch.from_numpy(dy).permute(0, 3, 1, 2).to(ty.dtype))
    assert ty.dtype == tdt
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)

    def nhwc(t):
        return t.detach().float().permute(0, 2, 3, 1).numpy()

    np.testing.assert_allclose(nhwc(ty), np.asarray(jy, np.float32), **tol)
    np.testing.assert_allclose(nhwc(tx.grad), np.asarray(jdx, np.float32),
                               **tol)
    # dw, db: fp32 sums over 168 entries of bf16-rounded values
    sums = TOL if dtype == "float32" else dict(atol=1e-1, rtol=1e-2)
    np.testing.assert_allclose(sbn.weight.grad.numpy(), np.asarray(jdw),
                               **sums)
    np.testing.assert_allclose(sbn.bias.grad.numpy(), np.asarray(jdb),
                               **sums)
    stats = jupd["batch_stats"]
    np.testing.assert_allclose(sbn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(sbn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-6,
                               rtol=1e-5)


def test_convert_syncbn_model_replaces_every_batchnorm():
    torch.manual_seed(0)
    net = torch.nn.Sequential(
        torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4, momentum=0.2),
        torch.nn.Sequential(torch.nn.Tanh(), torch.nn.BatchNorm2d(4)),
        torch.nn.Flatten(), torch.nn.BatchNorm1d(4 * 6 * 6, affine=False))
    # well-conditioned statistics (E[x^2] - mean^2 cancels where a
    # feature's variance is small beside its mean; Welford does not)
    x = torch.randn(64, 3, 8, 8)
    with torch.no_grad():
        net[1].weight.uniform_(0.5, 1.5)
        net[1].running_mean.uniform_(-1, 1)
        net.train()
        want_train = net(x)
        net.eval()
        want_eval = net(x)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    converted = convert_syncbn_model(net)
    assert converted is net
    sbns = [m for m in net.modules() if isinstance(m, SyncBatchNorm)]
    assert len(sbns) == 3
    assert not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                   for m in net.modules())
    assert net[1].momentum == 0.2 and not net[4].affine
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
    with torch.no_grad():
        np.testing.assert_allclose(net(x).numpy(), want_eval.numpy(), **TOL)
        net.train()
        np.testing.assert_allclose(net(x).numpy(), want_train.numpy(),
                                   atol=1e-5, rtol=1e-4)
    alone = convert_syncbn_model(torch.nn.BatchNorm2d(3))
    assert isinstance(alone, SyncBatchNorm)


def test_ddp_facade_calls_the_module_and_refuses_many_ranks(monkeypatch):
    net = torch.nn.Linear(3, 2)
    ddp = DistributedDataParallel(net, message_size=123,
                                  delay_allreduce=True,
                                  gradient_predivide_factor=2.0)
    x = torch.randn(4, 3)
    assert torch.equal(ddp(x), net(x))
    assert ddp.message_size == 123 and ddp.delay_allreduce
    grads = {"w": torch.ones(2)}
    assert ddp.allreduce_gradients(grads) is grads
    assert list(ddp.parameters()) == list(net.parameters())
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="item 10"):
        ddp.allreduce_gradients(grads)
    with pytest.raises(NotImplementedError, match="item 10"):
        DistributedDataParallel(net)
    with pytest.raises(NotImplementedError, match="item 10"):
        SyncBatchNorm(2).train()(torch.randn(3, 2, 4, 4))


@pytest.mark.parametrize("level,atol,rtol", [("O0", 0.0, 1e-5),
                                              ("O1", 2e-2, 2e-2)])
def test_run_training_losses_match_jax(ref, level, atol, rtol):
    want = ref["ex"].run_training(ref["ex"].resnet_tiny(), steps=4,
                                  batch_size=B, image_size=IMG,
                                  opt_level=level, lr=0.05,
                                  verbose=lambda *a: None)
    tm, _, _ = _port(ref)
    got = pm.run_training(tm, steps=4, batch_size=B, image_size=IMG,
                          opt_level=level, lr=0.05, device="cpu",
                          verbose=lambda *a: None)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert got[-1] < got[0]


def test_o1_seam_flips_the_conv_compute_dtype(ref):
    tm, x, _ = _port(ref)
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append((type(mod).__name__, out.dtype)))
        for m in tm.modules() if isinstance(m, (pm.Conv2d, SyncBatchNorm))]
    with torch.no_grad():
        tm(x)
        assert {d for _, d in seen} == {torch.float32}
        seen.clear()
        amp.initialize(tm, opt_level="O1")
        out = tm(x)
    for h in hooks:
        h.remove()
    assert {d for _, d in seen} == {torch.bfloat16}
    assert out.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_resnet50_sizes_and_flops():
    m = pm.resnet50(device="meta")
    named = list(m.named_parameters())
    assert len(named) == 161
    assert sum(p.numel() for _, p in named) == 25_557_032
    assert flat_buffer.build_spec(named).total_rows == 25_021
    assert pm.resnet_train_flops(m, 1, 224) / 3 == pytest.approx(8.18e9,
                                                                 rel=1e-3)
    assert pm.resnet_train_flops(m, 256, 224) == 6_280_987_017_216


def test_main_runs_on_the_cpu(capsys):
    pm.main(["--arch", "resnet_tiny", "--steps", "2", "--batch-size", "4",
             "--image-size", "16", "--device", "cpu", "--lr", "0.01"])
    assert "final loss" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="item 11"):
        pm.main(["--arch", "resnet_tiny", "--steps", "1", "--device", "cpu",
                 "--opt-level", "O2", "--image-size", "16"])


def test_build_training_takes_novograd_and_refuses_other_optimizers():
    tm = pm.resnet_tiny(device="cpu", seed=0)
    x, y = pm.synthetic_batch(np.random.default_rng(0), 4, IMG, CLASSES,
                              device="cpu")
    opt, _, step = pm.build_training(tm, opt_level="O0", lr=0.01,
                                     optimizer="novograd")
    assert type(opt).__name__ == "FusedNovoGrad"
    losses = [float(step(x, y)) for _ in range(2)]
    assert all(np.isfinite(losses)) and int(opt.step_count) == 2
    with pytest.raises(ValueError, match="'sgd' or 'novograd'"):
        pm.build_training(tm, optimizer="adam")
