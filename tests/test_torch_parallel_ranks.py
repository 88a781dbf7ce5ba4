"""``apex_tpu_torch.parallel`` across two spawned ``gloo`` ranks: the cases
of ``tests/test_parallel.py:23-156`` and the amp found-inf agreement.

- SyncBatchNorm, each rank on its half of a batch of 16: the outputs, the
  running statistics and the gradients (input: the derivative of the sum
  of both ranks' losses; weight and bias: each rank's part, summed) against
  JAX's ``SyncBatchNorm`` over the ``data`` axis of the 8-device mesh and
  against ``torch``'s BatchNorm on the gathered batch;
- DDP's ``allreduce_gradients`` (average, sum, a pre-divide factor, fp32
  reduction) against JAX's over a 2-device ``data`` mesh, its in-place
  form over a module's ``.grad``s, and the parameter broadcast from rank 0;
- the DDP example's losses against the JAX example's, and ResNet (tiny)
  through ``examples/imagenet/main_amp.py`` on two ranks against one rank
  on the whole batch;
- under tensor parallelism, one rank's overflow skips the amp step on
  both ranks and halves both scalers;
- the ranks start with their parent's cuDNN and cuBLAS flags, and the
  backend follows from where the tensors live and how many cards there
  are.

The ranks run every case once, in a module fixture.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from _torch_tp_worker import bn_inputs, parallel_worker
from apex_tpu.mesh import DATA_AXIS
from apex_tpu_torch.parallel import run_ranks
from apex_tpu_torch.parallel import spawn

STEPS = 6
#: fp32 bars: forward and statistics 1e-5, gradients 1e-4 (the JAX tests')
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


#: the parent's flags while it starts the ranks: torch's defaults flipped
PARENT_FLAGS = {("cudnn", "deterministic"): True, ("cudnn", "benchmark"): True,
                ("cudnn", "allow_tf32"): False,
                ("cuda.matmul", "allow_tf32"): True}


@pytest.fixture(scope="module")
def ranks():
    saved = spawn.backend_flags()
    spawn.set_backend_flags(PARENT_FLAGS)
    try:
        return run_ranks(parallel_worker, 2, (STEPS,), threads=1,
                         timeout=150)
    finally:
        spawn.set_backend_flags(saved)


def test_ranks_start_with_the_parents_backend_flags(ranks):
    for r in ranks:
        assert r["flags"] == PARENT_FLAGS


@pytest.mark.parametrize("device,cards,want", [
    ("cpu", 4, "gloo"), ("cuda", 1, "gloo"), ("cuda", 2, "nccl"),
    ("cuda:0", 4, "nccl")])
def test_backend_follows_the_tensors_and_the_cards(monkeypatch, device,
                                                  cards, want):
    """nccl only for tensors on the card with a card for each of the
    host's two ranks (NCCL refuses two ranks on one card), else gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.distributed, "is_nccl_available",
                        lambda: True)
    assert spawn.choose_backend(2, device) == want


@pytest.fixture(scope="module")
def jax_bn():
    """JAX's SyncBatchNorm over the 8-device data mesh on the same batch
    (NHWC): outputs, running statistics and the gradients of the summed
    squares (input and parameters)."""
    from apex_tpu.parallel import SyncBatchNorm
    from apex_tpu.transformer import parallel_state

    inp = bn_inputs()
    x = jnp.asarray(inp["x"].transpose(0, 2, 3, 1))
    bn = SyncBatchNorm(num_features=8, axis_name=DATA_AXIS)
    v = bn.init(jax.random.PRNGKey(0), x[:2])
    v = {"params": {"weight": jnp.asarray(inp["w"]),
                    "bias": jnp.asarray(inp["b"])},
         "batch_stats": v["batch_stats"]}
    mesh = parallel_state.initialize_model_parallel(1, 1)
    try:
        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P(), P(DATA_AXIS)),
                           out_specs=(P(DATA_AXIS), P(), P(DATA_AXIS), P()))
        def run(vv, xs):
            def loss(params, xx):
                y, st = bn.apply({"params": params,
                                  "batch_stats": vv["batch_stats"]}, xx,
                                 mutable=["batch_stats"])
                return jnp.sum(y * y), (y, st)

            (_, (y, st)), (gp, gx) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(vv["params"], xs)
            return y, st, gx, gp

        y, st, gx, gp = run(v, x)
    finally:
        parallel_state.destroy_model_parallel()
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return dict(y=nchw(y), dx=nchw(gx), dw=np.asarray(gp["weight"]),
                db=np.asarray(gp["bias"]),
                mean=np.asarray(st["batch_stats"]["mean"]),
                var=np.asarray(st["batch_stats"]["var"]))


@pytest.fixture(scope="module")
def torch_bn():
    """``torch``'s BatchNorm on the gathered batch: the same values."""
    inp = bn_inputs()
    x = torch.from_numpy(inp["x"]).requires_grad_()
    w = torch.from_numpy(inp["w"]).requires_grad_()
    b = torch.from_numpy(inp["b"]).requires_grad_()
    rm, rv = torch.zeros(8), torch.ones(8)
    y = torch.nn.functional.batch_norm(x, rm, rv, w, b, training=True,
                                       momentum=0.1, eps=1e-5)
    (y * y).sum().backward()
    return dict(y=y.detach().numpy(), dx=x.grad.numpy(), dw=w.grad.numpy(),
                db=b.grad.numpy(), mean=rm.numpy(), var=rv.numpy())


def _gathered(ranks, key):
    return np.concatenate([r[key] for r in ranks])


@pytest.mark.parametrize("ref", ["jax", "torch"])
def test_syncbn_forward_and_running_stats(ranks, jax_bn, torch_bn, ref):
    want = jax_bn if ref == "jax" else torch_bn
    np.testing.assert_allclose(_gathered(ranks, "bn_y"), want["y"],
                               **FWD_TOL)
    for r in ranks:
        np.testing.assert_allclose(r["bn_mean"], want["mean"], **FWD_TOL)
        np.testing.assert_allclose(r["bn_var"], want["var"], **FWD_TOL)


@pytest.mark.parametrize("ref", ["jax", "torch"])
def test_syncbn_backward_across_ranks(ranks, jax_bn, torch_bn, ref):
    want = jax_bn if ref == "jax" else torch_bn
    np.testing.assert_allclose(_gathered(ranks, "bn_dx"), want["dx"],
                               **GRAD_TOL)
    np.testing.assert_allclose(sum(r["bn_dw"] for r in ranks), want["dw"],
                               **GRAD_TOL)
    np.testing.assert_allclose(sum(r["bn_db"] for r in ranks), want["db"],
                               **GRAD_TOL)


def test_ddp_allreduce_gradients_matches_jax(ranks):
    """The four knob settings against JAX's ``allreduce_gradients`` over a
    2-device data mesh."""
    from apex_tpu.parallel import DistributedDataParallel as JaxDDP

    grads = np.stack(bn_inputs()["grads"])
    mesh = Mesh(np.asarray(jax.devices()[:2]), (DATA_AXIS,))
    knobs = [dict(), dict(gradient_average=False),
             dict(gradient_predivide_factor=2.0),
             dict(allreduce_always_fp32=True)]
    for i, k in enumerate(knobs):
        ddp = JaxDDP(None, **k)

        @functools.partial(jax.shard_map, mesh=mesh, in_specs=P(DATA_AXIS),
                           out_specs=P(DATA_AXIS))
        def red(g):
            return ddp.allreduce_gradients({"w": g[0]})["w"][None]

        want = np.asarray(red(jnp.asarray(grads)))
        for r, rank in enumerate(ranks):
            np.testing.assert_allclose(rank["ddp"][i], want[r], rtol=1e-6,
                                       err_msg=str(k))


def test_ddp_broadcasts_rank0_and_reduces_in_place(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["ddp_weight"], np.zeros((4, 3)))
        w, b = r["ddp_inplace"]
        np.testing.assert_array_equal(w, np.full((4, 3), 1.5))
        np.testing.assert_array_equal(b, np.full((4,), 1.5))


def test_ddp_example_losses_fall_as_the_jax_example(ranks):
    """The example on two ranks against the JAX example's losses (same
    batches, the whole batch's loss)."""
    import importlib.util
    import os

    from apex_tpu.transformer import parallel_state

    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "simple", "distributed",
                        "distributed_data_parallel.py")
    spec = importlib.util.spec_from_file_location("jax_ddp_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    try:
        want = mod.run_training(STEPS, verbose=lambda *_: None)
    finally:
        parallel_state.destroy_model_parallel()
    for r in ranks:
        np.testing.assert_allclose(r["example_losses"], want, rtol=1e-4)
    assert want[-1] < want[0]


def test_main_amp_two_ranks_match_one_rank_on_the_whole_batch(ranks):
    """ResNet (tiny) O0 through the example on two ranks of 4 images: the
    mean of the ranks' losses is one rank's loss on the 8 images."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.imagenet import main_amp

    torch.manual_seed(0)
    try:
        want = main_amp.run_training(
            main_amp.resnet_tiny(device="cpu"), steps=3, batch_size=8,
            image_size=16, opt_level="O0", device="cpu",
            verbose=lambda *_: None)
    finally:
        amp.reset()
    got = np.mean([r["resnet_losses"] for r in ranks], axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_one_ranks_overflow_skips_the_amp_step_on_every_rank(ranks):
    for r in ranks:
        skipped, clean = r["found_inf"]
        assert skipped["unchanged"] and skipped["step_count"] == 0
        assert skipped["scale"] == 2.0 ** 7
        assert not clean["unchanged"] and clean["step_count"] == 1
