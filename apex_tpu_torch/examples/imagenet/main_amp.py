"""ImageNet-style ResNet-50 training with amp, SyncBatchNorm, DDP and
FusedSGD, on one GPU.

Counterpart of ``examples/imagenet/main_amp.py`` of the JAX package (the
reference's ``examples/imagenet/main_amp.py``): ResNet-v1 with bottleneck
blocks, every BatchNorm a ``SyncBatchNorm``, ``amp.initialize`` (O0 or
O1), the ``DistributedDataParallel`` facade and ``FusedSGD(lr,
momentum=0.9, weight_decay=1e-4)`` (or ``FusedNovoGrad``), on a synthetic
batch from a numpy seed reused every step, as the reference's synthetic
mode. The layout is torch's NCHW; on the card the activations and the conv
weights run in ``channels_last`` memory format, which changes no value.
The modules read ``amp.resolve_compute_dtype`` at forward time, so O1
computes the convolutions and ``fc`` in the half dtype over fp32
parameters, and the norms in fp32. Convolutions, pooling, ``fc`` and
``log_softmax`` are cuDNN, cuBLAS and torch ops, as the reference leaves
them to XLA.

Run:  python -m apex_tpu_torch.examples.imagenet.main_amp --steps 20
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import FusedNovoGrad, FusedSGD
from apex_tpu_torch.parallel import DistributedDataParallel, SyncBatchNorm


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator) -> None:
    """flax's default kernel init: a normal of variance 1 / fan_in cut at
    two standard deviations (and rescaled to keep that variance)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class Conv2d(nn.Module):
    """A bias-free convolution whose fp32 weight is cast to the compute
    dtype at each call (and to ``channels_last`` when x is in it)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel,
                                               device=device))

    def reset_parameters(self, generator) -> None:
        w = self.weight
        _lecun_normal_(w.data, w.shape[1] * w.shape[2] * w.shape[3],
                       generator)

    def forward(self, x, dt):
        fmt = (torch.channels_last
               if x.is_contiguous(memory_format=torch.channels_last)
               and not x.is_contiguous() else torch.preserve_format)
        w = self.weight.to(dtype=dt, memory_format=fmt)
        return F.conv2d(x.to(dt), w, None, self.stride, self.padding)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 and the residual, each conv followed by a
    SyncBatchNorm; a strided or widening block adds ``downsample_conv`` and
    ``downsample_bn``, as the reference's."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 device=None):
        super().__init__()
        bn = dict(device=device)
        self.conv1 = Conv2d(cin, features, 1, device=device)
        self.bn1 = SyncBatchNorm(features, **bn)
        self.conv2 = Conv2d(features, features, 3, stride, 1, device=device)
        self.bn2 = SyncBatchNorm(features, **bn)
        self.conv3 = Conv2d(features, features * 4, 1, device=device)
        self.bn3 = SyncBatchNorm(features * 4, **bn)
        if cin != features * 4 or stride != 1:
            self.downsample_conv = Conv2d(cin, features * 4, 1, stride,
                                          device=device)
            self.downsample_bn = SyncBatchNorm(features * 4, **bn)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x):
        dt = amp.resolve_compute_dtype(x.dtype)
        y = F.relu(self.bn1(self.conv1(x, dt)))
        y = F.relu(self.bn2(self.conv2(y, dt)))
        y = self.bn3(self.conv3(y, dt))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x, dt))
        return F.relu(y + residual.to(y.dtype))


class ResNet(nn.Module):
    """ResNet-v1 with bottleneck blocks (50 = [3, 4, 6, 3]), NCHW input.
    Weights are drawn on the CPU from ``seed`` (flax's inits: LeCun normal
    kernels, zero ``fc`` bias, unit norms) and moved to ``device``. On the
    card the activations run in ``channels_last``."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, width: int = 64, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.num_classes, self.width = num_classes, width
        init_device = "meta" if str(device) == "meta" else "cpu"
        self.conv1 = Conv2d(3, width, 7, 2, 3, device=init_device)
        self.bn1 = SyncBatchNorm(width, device=init_device)
        self.block_names = []
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            for b in range(n_blocks):
                stride = 2 if (i > 0 and b == 0) else 1
                name = f"stage{i}_block{b}"
                self.add_module(name, Bottleneck(
                    cin, width * 2 ** i, stride, device=init_device))
                self.block_names.append(name)
                cin = width * 2 ** i * 4
        self.fc = nn.Linear(cin, num_classes, device=init_device)
        if init_device == "cpu":
            g = torch.Generator().manual_seed(seed)
            for m in self.modules():
                if isinstance(m, Conv2d):
                    m.reset_parameters(g)
            with torch.no_grad():
                _lecun_normal_(self.fc.weight, cin, g)
                self.fc.bias.zero_()
            self.to(device)

    def forward(self, x):
        dt = amp.resolve_compute_dtype(x.dtype)
        x = x.to(dt)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn1(self.conv1(x, dt)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        x = F.linear(x, self.fc.weight.to(dt), self.fc.bias.to(dt))
        return x.float()


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes, **kw)


def resnet_tiny(num_classes: int = 10, **kw) -> ResNet:
    """The reference's small variant for tests: two stages of one block,
    width 16."""
    return ResNet(stage_sizes=(1, 1), num_classes=num_classes, width=16,
                  **kw)


def resnet_train_flops(model: ResNet, batch_size: int,
                       image_size: int) -> float:
    """FLOPs of one training step: 3x the forward's multiply-adds (2
    FLOPs each) of every convolution and of ``fc``, counted from their
    shapes (the backward takes two products of the forward's size). Norms,
    pooling and the optimizer are left out."""
    h = image_size
    fwd = 0.0

    def conv(c: Conv2d, h_in: int) -> int:
        o, i, k, _ = c.weight.shape
        h_out = (h_in + 2 * c.padding - k) // c.stride + 1
        nonlocal fwd
        fwd += 2.0 * o * i * k * k * h_out * h_out
        return h_out

    h = conv(model.conv1, h)
    h = (h + 2 - 3) // 2 + 1                      # max pool 3, stride 2
    for name in model.block_names:
        blk = getattr(model, name)
        h1 = conv(blk.conv1, h)
        h2 = conv(blk.conv2, h1)
        conv(blk.conv3, h2)
        if blk.downsample_conv is not None:
            conv(blk.downsample_conv, h)
        h = h2
    fwd += 2.0 * model.fc.weight.numel()
    return 3.0 * fwd * batch_size


class AverageMeter:
    """The reference's ``AverageMeter``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def synthetic_batch(rng, batch_size: int, image_size: int, num_classes: int,
                    device="cuda"):
    """The reference's synthetic batch from a numpy generator, NCHW: the
    same draws as its NHWC images, transposed, and int64 labels."""
    images = np.asarray(rng.standard_normal(
        (batch_size, image_size, image_size, 3)), dtype=np.float32)
    labels = rng.integers(0, num_classes, (batch_size,))
    return (torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
            .to(device),
            torch.from_numpy(labels.astype(np.int64)).to(device))


def nll_loss(logits, labels):
    """Mean negative log-likelihood of ``labels`` under ``log_softmax``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def build_training(model: ResNet, *, opt_level: str = "O1", lr: float = 0.1,
                   half_dtype=torch.bfloat16, optimizer: str = "sgd"):
    """``(optimizer, ddp, step)`` for ``model`` (on its device): the fused
    optimizer over its parameters, ``amp.initialize``, the DDP facade, and
    ``step(images, labels)``, one training step returning the loss as a
    device tensor (no host read)."""
    named = list(model.named_parameters())
    if optimizer == "sgd":
        opt = FusedSGD(named, lr=lr, momentum=0.9, weight_decay=1e-4)
    elif optimizer == "novograd":
        opt = FusedNovoGrad(named, lr=lr, weight_decay=1e-4)
    else:
        raise ValueError(f"optimizer {optimizer!r}: 'sgd' or 'novograd'")
    model, opt = amp.initialize(model, opt, opt_level=opt_level,
                                half_dtype=half_dtype)
    ddp = DistributedDataParallel(model)

    def step(images, labels):
        opt.zero_grad()
        loss = nll_loss(ddp(images), labels)
        loss.backward()
        ddp.allreduce_gradients()
        opt.step()
        return loss.detach()

    return opt, ddp, step


def run_training(model: ResNet, *, steps: int = 10, batch_size: int = 8,
                 image_size: int = 32, opt_level: str = "O1",
                 lr: float = 0.1, seed: int = 0, device="cuda",
                 verbose=print):
    """The example's train loop, importable for tests: ``model`` moved to
    ``device``, ``steps`` steps on one synthetic batch; returns the
    losses."""
    rng = np.random.default_rng(seed)
    images, labels = synthetic_batch(rng, batch_size, image_size,
                                     model.num_classes, device=device)
    model.to(device)
    model.train()
    _, _, step = build_training(model, opt_level=opt_level, lr=lr)
    losses, meter, t0 = [], AverageMeter(), time.perf_counter()
    for i in range(steps):
        loss = float(step(images, labels))
        losses.append(loss)
        meter.update(loss)
        if i % 5 == 0:
            verbose(f"step {i:4d}  loss {meter.val:.4f} "
                    f"(avg {meter.avg:.4f})  "
                    f"{(time.perf_counter() - t0):.1f}s")
    return losses


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--opt-level", default="O1",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--arch", default="resnet50",
                   choices=["resnet50", "resnet_tiny"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    make = resnet50 if args.arch == "resnet50" else resnet_tiny
    losses = run_training(make(device=args.device), steps=args.steps,
                          batch_size=args.batch_size,
                          image_size=args.image_size,
                          opt_level=args.opt_level, lr=args.lr,
                          device=args.device)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
