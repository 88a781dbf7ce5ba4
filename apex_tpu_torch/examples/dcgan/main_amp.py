"""DCGAN with amp: two models, two optimizers and two losses under one
``amp.initialize`` (the multi-loss pattern), on one GPU.

Counterpart of ``examples/dcgan/main_amp.py`` of the JAX package (the
reference's ``examples/dcgan/main_amp.py``): a generator and a
discriminator (small MLPs, flax ``nn.Dense`` layers with their ``(in,
out)`` kernels and names), each with its own ``FusedAdam(lr=2e-4,
betas=(0.5, 0.999))``, ``amp.initialize([g, d], [g_opt, d_opt],
num_losses=2)`` and ``amp.scale_loss(..., loss_id=)``: the generator's loss
is loss 0 and its scaler is attached to ``g_opt``, the discriminator's is
loss 1 on ``d_opt``, so under a dynamic fp16 scaler each optimizer skips
and each scale halves on its own loss's overflow only. Synthetic data from
a numpy seed, drawn in the reference's order. The modules read
``amp.resolve_compute_dtype`` at forward time; under O2 their parameters
are half copies of the optimizers' fp32 masters.

Run:  python -m apex_tpu_torch.examples.dcgan.main_amp --steps 20
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import amp
from apex_tpu_torch.examples.imagenet.main_amp import _lecun_normal_
from apex_tpu_torch.optimizers import FusedAdam

OUT_DIM = 64
HIDDEN = 128


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with a ``(in, out)``
    kernel, inputs, kernel and bias cast to the compute dtype ``dt``."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def reset_parameters(self, generator) -> None:
        """flax's default init: LeCun normal kernel, zero bias."""
        with torch.no_grad():
            _lecun_normal_(self.kernel, self.kernel.shape[0], generator)
            self.bias.zero_()

    def forward(self, x, dt):
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


def _init(module: nn.Module, device, seed: int) -> None:
    """Draw the Dense layers on the CPU from ``seed``, then move to
    ``device``."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, Dense):
            m.reset_parameters(g)
    module.to(device)


class Generator(nn.Module):
    """latent -> Dense(128) -> ReLU -> Dense(out) -> tanh."""

    def __init__(self, latent: int = 32, out_dim: int = OUT_DIM,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.Dense_0 = Dense(latent, HIDDEN, device="cpu")
        self.Dense_1 = Dense(HIDDEN, out_dim, device="cpu")
        _init(self, device, seed)

    def forward(self, z):
        dt = amp.resolve_compute_dtype(z.dtype)
        h = F.relu(self.Dense_0(z, dt))
        return torch.tanh(self.Dense_1(h, dt))


class Discriminator(nn.Module):
    """in -> Dense(128) -> leaky ReLU 0.2 -> Dense(1): fp32 logits
    ``[B]``."""

    def __init__(self, in_dim: int = OUT_DIM, device="cuda", seed: int = 1):
        super().__init__()
        self.Dense_0 = Dense(in_dim, HIDDEN, device="cpu")
        self.Dense_1 = Dense(HIDDEN, 1, device="cpu")
        _init(self, device, seed)

    def forward(self, x):
        dt = amp.resolve_compute_dtype(x.dtype)
        h = F.leaky_relu(self.Dense_0(x, dt), 0.2)
        return self.Dense_1(h, dt)[..., 0].float()


def bce_with_logits(logits, target: float):
    """The reference's mean binary cross-entropy on logits."""
    return torch.mean(torch.clamp(logits, min=0) - logits * target
                      + torch.log1p(torch.exp(-logits.abs())))


def build_training(g: Generator, d: Discriminator, *, opt_level: str = "O1",
                   half_dtype=torch.bfloat16, lr: float = 2e-4):
    """``(g_opt, d_opt, step)``: the two FusedAdams, ``amp.initialize``
    with ``num_losses=2`` (the models cast in place under O2/O3), and
    ``step(z, real)``: the discriminator's update on real and detached fake
    samples (loss 1), then the generator's through the updated
    discriminator (loss 0). ``step`` returns the two scaled losses as
    device tensors, as the reference's loop records them."""
    g_opt = FusedAdam(g.named_parameters(), lr=lr, betas=(0.5, 0.999))
    d_opt = FusedAdam(d.named_parameters(), lr=lr, betas=(0.5, 0.999))
    (g, d), (g_opt, d_opt) = amp.initialize(
        [g, d], [g_opt, d_opt], opt_level=opt_level, half_dtype=half_dtype,
        num_losses=2)

    def step(z, real):
        d_opt.zero_grad()
        fake = g(z).detach()
        loss = (bce_with_logits(d(real), 1.0)
                + bce_with_logits(d(fake), 0.0))
        with amp.scale_loss(loss, d_opt, loss_id=1) as scaled_d:
            scaled_d.backward()
        d_opt.step()
        g_opt.zero_grad()
        loss = bce_with_logits(d(g(z)), 1.0)
        with amp.scale_loss(loss, g_opt, loss_id=0) as scaled_g:
            scaled_g.backward()
        g_opt.step()
        return scaled_d.detach(), scaled_g.detach()

    return g_opt, d_opt, step


def synthetic_batches(seed: int, steps: int, batch: int, latent: int,
                      device="cuda"):
    """The reference's draws from ``default_rng(seed)``: the two init
    samples (which only shape its flax init), then ``(z, real)`` a step,
    ``real = tanh(0.5 N(0, 1))``."""
    rng = np.random.default_rng(seed)
    rng.standard_normal((batch, latent))
    rng.standard_normal((batch, OUT_DIM))

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

    out = []
    for _ in range(steps):
        z = t(rng.standard_normal((batch, latent)))
        real = t(np.tanh(rng.standard_normal((batch, OUT_DIM)) * 0.5))
        out.append((z, real))
    return out


def run_training(*, steps: int = 20, batch: int = 32, latent: int = 32,
                 opt_level: str = "O1", half_dtype=torch.bfloat16,
                 seed: int = 0, verbose=print, device="cuda",
                 state_dicts=None):
    """The example's train loop, importable for tests: ``steps`` steps on
    fresh synthetic batches; returns the discriminator's and the
    generator's (scaled) losses per step. ``state_dicts``: optional
    ``(generator, discriminator)`` weights (e.g. the reference's, through
    ``bridge.dcgan_params_from_flax``); by default the seeded init."""
    g = Generator(latent=latent, device=device, seed=seed)
    d = Discriminator(device=device, seed=seed + 1)
    if state_dicts is not None:
        g.load_state_dict(state_dicts[0])
        d.load_state_dict(state_dicts[1])
    _, _, step = build_training(g, d, opt_level=opt_level,
                                half_dtype=half_dtype)
    d_losses, g_losses = [], []
    for i, (z, real) in enumerate(synthetic_batches(seed, steps, batch,
                                                    latent, device)):
        dl, gl = step(z, real)
        d_losses.append(float(dl))
        g_losses.append(float(gl))
        if i % 10 == 0:
            verbose(f"step {i:4d}  D {d_losses[-1]:.4f}  "
                    f"G {g_losses[-1]:.4f}")
    return d_losses, g_losses


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--opt-level", default="O1",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--half-dtype", default="bfloat16",
                   choices=["bfloat16", "float16"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    d, g = run_training(steps=args.steps, opt_level=args.opt_level,
                        half_dtype=getattr(torch, args.half_dtype),
                        device=args.device)
    print(f"final D {d[-1]:.4f}  G {g[-1]:.4f}")


if __name__ == "__main__":
    main()
