"""Transformer NMT over ``contrib.multihead_attn`` and the label-smoothed
softmax cross entropy (BASELINE config #3), on one GPU.

Counterpart of ``examples/nmt/main.py`` of the JAX package: a pre-LN
encoder-decoder over ``[seq, batch, embed]`` activations, each encoder
layer a ``SelfMultiheadAttn`` (``include_norm_add``) and a ReLU FFN behind
a ``FusedLayerNorm``, each decoder layer a causal ``SelfMultiheadAttn``
(the reference's additive ``[sq, sq]`` -1e9 mask, ``mask_additive``), an
``EncdecMultiheadAttn`` over the encoder output and the FFN; token and
learned position embeddings (normal(0.02)), the output projection tied to
the token embedding, and ``SoftmaxCrossEntropyLoss`` (label smoothing,
``padding_idx`` 0) on the fp32 logits, ``FusedAdam(lr=3e-4)``. The task
is the reference's synthetic copy: the target is the source, teacher
forced, drawn from a numpy ``default_rng`` so that one seed gives the
reference's batches. Under amp O1 only the attention modules compute in
the half dtype; the FFN and the tied projection stay fp32, as the
reference's residual adds promote to fp32.

Run:  python -m apex_tpu_torch.examples.nmt.main --steps 30
"""

from __future__ import annotations

import argparse
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                   SelfMultiheadAttn)
from apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.optimizers import FusedAdam

#: rows of the learned position table, as the reference's
MAX_POSITIONS = 512


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``nn.Dense``'s default kernel init on a ``(out, in)`` weight: a
    normal of variance 1 / in cut at two standard deviations (rescaled to
    keep that variance), drawn on the CPU ``generator``."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    t = torch.empty(w.shape)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    w.copy_(t)


class _FFN(nn.Module):
    """``x + fc2(relu(fc1(norm(x))))`` in the input's dtype (fp32 in the
    model)."""

    def __init__(self, embed_dim: int, ffn_dim: int, device):
        super().__init__()
        self.ffn_norm = FusedLayerNorm(embed_dim, device=device)
        self.fc1 = nn.Linear(embed_dim, ffn_dim, device=device)
        self.fc2 = nn.Linear(ffn_dim, embed_dim, device=device)

    def ffn(self, x):
        return x + self.fc2(F.relu(self.fc1(self.ffn_norm(x))))


class EncoderLayer(_FFN):
    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.0, *, device="cuda",
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__(embed_dim, ffn_dim, device)
        self.self_attn = SelfMultiheadAttn(
            embed_dim, num_heads, dropout=dropout, include_norm_add=True,
            impl="fast", device=device, dropout_generator=dropout_generator)

    def forward(self, x, *, train: bool):
        x, _ = self.self_attn(x, is_training=train)
        return self.ffn(x)


class DecoderLayer(_FFN):
    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.0, *, device="cuda",
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__(embed_dim, ffn_dim, device)
        self.self_attn = SelfMultiheadAttn(
            embed_dim, num_heads, dropout=dropout, include_norm_add=True,
            mask_additive=True, impl="fast", device=device,
            dropout_generator=dropout_generator)
        self.cross_attn = EncdecMultiheadAttn(
            embed_dim, num_heads, dropout=dropout, include_norm_add=True,
            impl="fast", device=device, dropout_generator=dropout_generator)

    def forward(self, y, memory, *, train: bool):
        sq = y.shape[0]
        pos = torch.arange(sq, device=y.device)
        causal = torch.where(pos[:, None] >= pos[None, :], 0.0, -1e9).to(
            torch.float32)
        y, _ = self.self_attn(y, attn_mask=causal, is_training=train)
        y, _ = self.cross_attn(y, memory, memory, is_training=train)
        return self.ffn(y)


class NMTTransformer(nn.Module):
    """The reference's pre-LN encoder-decoder with its fields (vocab_size,
    embed_dim, num_heads, ffn_dim, num_layers, dropout). ``forward(src_ids,
    tgt_ids, train=True)`` takes ``[B, S]`` ids and returns ``[B, S, V]``
    logits. Parameters live on ``device`` (the card unless the caller
    passes another), drawn from the CPU ``generator`` (seed 0 by default);
    every attention layer draws its dropout seeds from one CPU generator
    seeded by ``dropout_seed``, so two models built alike draw the same
    keep masks on any device."""

    def __init__(self, vocab_size: int = 1024, embed_dim: int = 128,
                 num_heads: int = 4, ffn_dim: int = 256, num_layers: int = 2,
                 dropout: float = 0.0, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        self.vocab_size, self.embed_dim = vocab_size, embed_dim
        self.num_heads, self.ffn_dim = num_heads, ffn_dim
        self.num_layers, self.dropout = num_layers, dropout
        self.dropout_generator = torch.Generator().manual_seed(dropout_seed)
        layer = dict(device=device, dropout_generator=self.dropout_generator)
        self.embed = nn.Parameter(torch.empty(vocab_size, embed_dim,
                                              device=device))
        self.pos = nn.Parameter(torch.empty(MAX_POSITIONS, embed_dim,
                                            device=device))
        self.enc_layers = nn.ModuleList(
            EncoderLayer(embed_dim, num_heads, ffn_dim, dropout, **layer)
            for _ in range(num_layers))
        self.enc_norm = FusedLayerNorm(embed_dim, device=device)
        self.dec_layers = nn.ModuleList(
            DecoderLayer(embed_dim, num_heads, ffn_dim, dropout, **layer)
            for _ in range(num_layers))
        self.dec_norm = FusedLayerNorm(embed_dim, device=device)
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    def init_weights(self, generator: torch.Generator) -> None:
        """normal(0.02) embeddings, the attention modules' xavier_uniform,
        flax ``nn.Dense``'s init for the FFN (truncated LeCun normal, zero
        bias), unit norms; every draw on the CPU ``generator``."""
        with torch.no_grad():
            for p in (self.embed, self.pos):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
            for lay in (*self.enc_layers, *self.dec_layers):
                for attn in (lay.self_attn, getattr(lay, "cross_attn", None)):
                    if attn is not None:
                        attn.reset_parameters(generator)
                for fc in (lay.fc1, lay.fc2):
                    _lecun_normal_(fc.weight, generator)
                    fc.bias.zero_()

    def _embed(self, ids):
        """``[B, S]`` ids -> ``[S, B, E]``."""
        x = self.embed[ids.long()] + self.pos[None, :ids.shape[1]]
        return x.transpose(0, 1)

    def forward(self, src_ids, tgt_ids, *, train: bool = True):
        x = self._embed(src_ids)
        for lay in self.enc_layers:
            x = lay(x, train=train)
        x = self.enc_norm(x)
        y = self._embed(tgt_ids)
        for lay in self.dec_layers:
            y = lay(y, x, train=train)
        y = self.dec_norm(y)
        # tied output projection, [B, S, V]
        return y.transpose(0, 1) @ self.embed.T


def synthetic_copy_batch(rng, batch: int, seq: int, vocab: int,
                         device="cuda"):
    """The copy task, as the reference draws it from a numpy
    ``default_rng``: ``(src, tgt_in, tgt_out)`` int32 ``[batch, seq]``,
    ``tgt_in`` the source shifted right behind a 1, ``tgt_out`` the
    source."""
    src = rng.integers(2, vocab, (batch, seq))
    tgt_in = np.concatenate([np.ones((batch, 1), np.int64), src[:, :-1]], 1)
    return tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                 for a in (src, tgt_in, src))


def nmt_loss(model: NMTTransformer, src, tgt_in, tgt_out,
             label_smoothing: float = 0.1, train: bool = True):
    """The mean label-smoothed cross entropy of the fp32 logits through the
    xentropy kernels (``padding_idx`` 0, which the batches never draw)."""
    logits = model(src, tgt_in, train=train)
    per_tok = SoftmaxCrossEntropyLoss()(
        logits.reshape(-1, model.vocab_size).float(), tgt_out.reshape(-1),
        smoothing=label_smoothing)
    return per_tok.mean()


def train_step(model: NMTTransformer, opt: FusedAdam, batch,
               label_smoothing: float = 0.1):
    """One step: zero the gradients, the loss and its backward, one
    FusedAdam step; returns the loss (a device scalar, not read)."""
    opt.zero_grad()
    loss = nmt_loss(model, *batch, label_smoothing=label_smoothing)
    loss.backward()
    opt.step()
    return loss.detach()


def run_training(*, steps: int = 30, batch: int = 8, seq: int = 16,
                 vocab: int = 256, label_smoothing: float = 0.1,
                 lr: float = 3e-4, seed: int = 0, verbose=print,
                 device="cuda"):
    """The reference's ``run_training``: the default model at ``vocab``, a
    batch drawn first (the reference initialises on it), then a fresh batch
    each step from the same ``default_rng(seed)``; returns the losses."""
    model = NMTTransformer(vocab_size=vocab, device=device,
                           generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    synthetic_copy_batch(rng, batch, seq, vocab, device)
    opt = FusedAdam(model.named_parameters(), lr=lr)
    losses = []
    for step in range(steps):
        data = synthetic_copy_batch(rng, batch, seq, vocab, device)
        losses.append(float(train_step(model, opt, data, label_smoothing)))
        if step % 10 == 0:
            verbose(f"step {step:4d}  loss {losses[-1]:.4f}")
    return losses


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    losses = run_training(steps=args.steps, batch=args.batch, seq=args.seq,
                          device=args.device)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
