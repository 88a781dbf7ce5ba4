"""Port parity: the DCGAN multi-loss amp example against
``examples/dcgan/main_amp.py``.

The JAX example is loaded by path, as ``tests/test_examples.py`` loads it.
Its flax ``Generator`` and ``Discriminator`` inits (the example's seeds and
init batches) go through ``bridge.dcgan_params_from_flax`` into the port's
``run_training``, which draws the same numpy batches: the per-step D and G
losses of 4 steps match JAX's ``run_training`` at O0 (1e-5) and at O1 bf16
(2e-2: both sides round every Dense output to bf16). Under O2 fp16 on the
CPU: two dynamic scalers, one per optimizer, every parameter an fp16 copy
of its optimizer's master; a batch with an inf sample makes the
discriminator's loss overflow, and only ``d_opt`` skips and only loss 1's
scale halves.
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
from apex_tpu_torch import amp
from apex_tpu_torch.bridge import dcgan_params_from_flax
from apex_tpu_torch.examples.dcgan import main_amp as pd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH, LATENT, SEED = 4, 32, 32, 0


@pytest.fixture(autouse=True)
def _reset_amp():
    yield
    jamp._current_policy = None
    jamp._loss_scalers = []
    amp.reset()


@pytest.fixture(scope="module")
def ref():
    name = "example_dcgan_port_parity"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples/dcgan/main_amp.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod   # flax dataclass processing looks it up
    spec.loader.exec_module(mod)
    return mod


def _jax_inits(ref):
    """The reference's init, as its ``run_training`` makes it."""
    rng = np.random.default_rng(SEED)
    z0 = jnp.asarray(rng.standard_normal((BATCH, LATENT)), jnp.float32)
    x0 = jnp.asarray(rng.standard_normal((BATCH, 64)), jnp.float32)
    g = ref.Generator(latent=LATENT).init(jax.random.PRNGKey(SEED), z0)
    d = ref.Discriminator().init(jax.random.PRNGKey(SEED + 1), x0)
    return tuple(dcgan_params_from_flax(jax.tree.map(np.asarray, t))
                 for t in (g, d))


def _quiet(*a, **k):
    pass


@pytest.mark.parametrize("level,tol", [("O0", 1e-5), ("O1", 2e-2)])
def test_run_training_matches_jax(ref, level, tol):
    want = ref.run_training(steps=STEPS, batch=BATCH, latent=LATENT,
                            opt_level=level, seed=SEED, verbose=_quiet)
    jamp._current_policy, jamp._loss_scalers = None, []
    got = pd.run_training(steps=STEPS, batch=BATCH, latent=LATENT,
                          opt_level=level, seed=SEED, verbose=_quiet,
                          device="cpu", state_dicts=_jax_inits(ref))
    for g, w, name in zip(got, want, ("D", "G")):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


def test_bridge_maps_both_modules_and_refuses_strangers(ref):
    g_sd, d_sd = _jax_inits(ref)
    assert set(g_sd) == set(pd.Generator(device="cpu").state_dict())
    assert set(d_sd) == set(pd.Discriminator(device="cpu").state_dict())
    with pytest.raises(KeyError, match="Conv_0"):
        dcgan_params_from_flax({"Conv_0": {"kernel": np.zeros(3)}})


def test_o2_fp16_forced_overflow_skips_only_its_optimizer():
    g = pd.Generator(latent=LATENT, device="cpu", seed=SEED)
    d = pd.Discriminator(device="cpu", seed=SEED + 1)
    g_opt, d_opt, step = pd.build_training(g, d, opt_level="O2",
                                           half_dtype=torch.float16)
    assert all(p.dtype == torch.float16 for p in
               list(g.parameters()) + list(d.parameters()))
    s_g, s_d = amp.loss_scalers()
    assert g_opt._amp_scaler is s_g and d_opt._amp_scaler is s_d
    assert s_g.dynamic and s_d.dynamic
    batches = pd.synthetic_batches(SEED, 3, BATCH, LATENT, "cpu")
    z, real = batches[2]
    batches[2] = (z, torch.where(torch.arange(BATCH)[:, None] == 5,
                                 float("inf"), real))
    for i, (z, real) in enumerate(batches):
        counts = int(g_opt.step_count), int(d_opt.step_count)
        scales = s_g.state.scale.item(), s_d.state.scale.item()
        dl, gl = step(z, real)
        overflow = i == 2
        assert not torch.isfinite(dl) == overflow, i
        assert torch.isfinite(gl), i
        assert int(d_opt.step_count) == counts[1] + (not overflow), i
        assert int(g_opt.step_count) == counts[0] + 1, i
        assert s_d.state.scale.item() == scales[1] / (2 if overflow else 1)
        assert s_g.state.scale.item() == scales[0], i
        for opt, m in ((g_opt, g), (d_opt, d)):
            master = amp.master_params(opt)
            for name, p in m.named_parameters():
                assert torch.equal(p.detach(), master[name].half()), name


def test_main_runs_on_the_cpu(capsys):
    pd.main(["--steps", "2", "--device", "cpu", "--opt-level", "O2"])
    assert "final D" in capsys.readouterr().out
