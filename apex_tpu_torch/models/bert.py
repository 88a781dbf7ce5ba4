"""BERT for pretraining: the flagship training model of the reference.

Counterpart of ``apex_tpu/models/bert.py`` (``BertConfig``,
``bert_large_config``, ``bert_tiny_config``, ``BertSelfAttention``,
``BertLayer``, ``BertForPreTraining``, ``bert_pretrain_loss``,
``synthetic_batch`` and ``make_pretrain_step``'s loss). Post-LN encoder
layers; fused QKV into flash attention (non-causal, the padding mask as
segment ids, attention dropout by the reference's counter-based keep mask,
so the masks are the reference's bit for bit); ``FusedLayerNorm`` (the
embedding norm in fp32 before the cast to the compute dtype); the MLM head
tied to the word embeddings, optionally gathered at ``masked_positions``;
the NSP head on the first token; the loss through the fused xentropy
kernel.

Weights keep the reference's ``(in, out)`` layout and names (``x @ W``), so
``bridge.bert_params_from_flax`` maps a flax tree one to one. The compute
dtype is ``BertConfig.dtype`` (the reference's amp O1 seam
``resolve_compute_dtype`` reads the same field when amp is off; amp is not
ported). Hidden dropout (after the embeddings, the attention output and the
MLP) draws from a ``torch.Generator`` on the model's device, seeded from the
step's dropout seed: it cannot match flax's threefry bits, only their rate
and scale.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy

_REMAT = ("BertConfig(remat=True) is not ported yet (ROADMAP queue A item "
          "11: per-layer rematerialization)")
_PARTITION = ("param_partition_specs is not ported yet (ROADMAP queue A "
              "items 10 and 12: tensor parallelism, parallel/)")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30528          # 30522 rounded up to a lane multiple
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layernorm_eps: float = 1e-12
    # tanh-approximate GELU (the reference's default); False = exact erf
    gelu_approximate: bool = True
    dtype: Any = torch.bfloat16      # compute dtype
    param_dtype: Any = torch.float32
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def bert_large_config(**overrides) -> BertConfig:
    return dataclasses.replace(BertConfig(), **overrides)


def bert_tiny_config(**overrides) -> BertConfig:
    """Toy config for unit tests, as the reference's."""
    base = BertConfig(
        vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
        intermediate_size=256, max_position_embeddings=128,
        hidden_dropout=0.0, attention_dropout=0.0, dtype=torch.float32)
    return dataclasses.replace(base, **overrides)


def _gelu(x, cfg: BertConfig):
    return F.gelu(x, approximate="tanh" if cfg.gelu_approximate else "none")


def hidden_dropout(x: torch.Tensor, rate: float,
                   generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``'s rule: keep with probability ``1 - rate`` and
    scale the kept values by ``1 / (1 - rate)``, drawing from
    ``generator``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def layer_dropout_seed(dropout_seed: int, layer: int) -> int:
    """``dropout_seed * 1000003 + layer`` wrapped to int32, as the
    reference decorrelates its layers' attention-dropout masks."""
    x = (int(dropout_seed) * 1000003 + layer) & 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def _param(shape, cfg, device, fill=None):
    t = torch.empty(shape, dtype=cfg.param_dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


class BertSelfAttention(nn.Module):
    """Fused QKV -> flash attention -> out-projection."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        cfg, e = config, config.hidden_size
        self.config = cfg
        self.qkv_weight = _param((e, 3 * e), cfg, device)
        self.qkv_bias = _param((3 * e,), cfg, device, 0.0)
        self.out_weight = _param((e, e), cfg, device)
        self.out_bias = _param((e,), cfg, device, 0.0)

    def forward(self, x, segment_ids, *, deterministic: bool,
                dropout_seed: int):
        cfg = self.config
        dt = cfg.dtype
        e, h, d = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        b, s, _ = x.shape
        qkv = x @ self.qkv_weight.to(dt) + self.qkv_bias.to(dt)
        q, k, v = qkv.chunk(3, dim=-1)

        def to_bhsd(t):
            return t.reshape(b, s, h, d).transpose(1, 2)

        rate = 0.0 if deterministic else cfg.attention_dropout
        ctx = flash_attention(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                              segment_ids=segment_ids, dropout_rate=rate,
                              dropout_seed=dropout_seed)
        ctx = ctx.transpose(1, 2).reshape(b, s, e)
        return ctx @ self.out_weight.to(dt) + self.out_bias.to(dt)


class BertLayer(nn.Module):
    """Post-LN encoder layer: attention -> dropout -> LN(x + .) -> GELU MLP
    -> dropout -> LN(x + .)."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        cfg, e, i = config, config.hidden_size, config.intermediate_size
        self.config = cfg
        norm = dict(param_dtype=cfg.param_dtype, device=device)
        self.attention = BertSelfAttention(cfg, device=device)
        self.attention_norm = FusedLayerNorm(e, cfg.layernorm_eps, **norm)
        self.mlp_weight1 = _param((e, i), cfg, device)
        self.mlp_bias1 = _param((i,), cfg, device, 0.0)
        self.mlp_weight2 = _param((i, e), cfg, device)
        self.mlp_bias2 = _param((e,), cfg, device, 0.0)
        self.mlp_norm = FusedLayerNorm(e, cfg.layernorm_eps, **norm)

    def forward(self, x, segment_ids, deterministic: bool = True, *,
                dropout_seed: int = 0,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        dt = cfg.dtype
        drop = not deterministic and cfg.hidden_dropout > 0.0
        attn_out = self.attention(x, segment_ids, deterministic=deterministic,
                                  dropout_seed=dropout_seed)
        if drop:
            attn_out = hidden_dropout(attn_out, cfg.hidden_dropout, generator)
        x = self.attention_norm(x + attn_out)
        hmid = _gelu(x @ self.mlp_weight1.to(dt) + self.mlp_bias1.to(dt), cfg)
        mlp_out = hmid @ self.mlp_weight2.to(dt) + self.mlp_bias2.to(dt)
        if drop:
            mlp_out = hidden_dropout(mlp_out, cfg.hidden_dropout, generator)
        return self.mlp_norm(x + mlp_out)


class BertForPreTraining(nn.Module):
    """Embeddings + encoder + MLM head + NSP head.

    ``forward(input_ids, token_type_ids, attention_mask)`` returns
    ``(mlm_logits [B, S, V], nsp_logits [B, 2])``; with ``masked_positions``
    ``[B, K]`` the MLM head runs at those K positions only and returns
    ``[B, K, V]`` (the reference harness's max_predictions_per_seq gather).
    ``deterministic=False`` turns on hidden and attention dropout, drawn
    from ``dropout_seed``. Parameters live on ``device`` (the card unless
    the caller passes another), initialised from ``generator`` (CPU, seed 0
    by default): normal(0.02) weights and embeddings, zero biases."""

    def __init__(self, config: BertConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.remat:
            raise NotImplementedError(_REMAT)
        cfg, e, v = config, config.hidden_size, config.vocab_size
        self.config = cfg
        norm = dict(param_dtype=cfg.param_dtype, device=device)
        self.word_embeddings = _param((v, e), cfg, device)
        self.position_embeddings = _param((cfg.max_position_embeddings, e),
                                          cfg, device)
        self.token_type_embeddings = _param((cfg.type_vocab_size, e), cfg,
                                            device)
        self.embedding_norm = FusedLayerNorm(e, cfg.layernorm_eps, **norm)
        self.layers = nn.ModuleList(BertLayer(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.mlm_dense_weight = _param((e, e), cfg, device)
        self.mlm_dense_bias = _param((e,), cfg, device, 0.0)
        self.mlm_output_bias = _param((v,), cfg, device, 0.0)
        self.mlm_norm = FusedLayerNorm(e, cfg.layernorm_eps, **norm)
        self.pooler_weight = _param((e, e), cfg, device)
        self.pooler_bias = _param((e,), cfg, device, 0.0)
        self.nsp_weight = _param((e, 2), cfg, device)
        self.nsp_bias = _param((2,), cfg, device, 0.0)
        self._generators: Dict[torch.device, torch.Generator] = {}
        if self.word_embeddings.device.type != "meta":
            self.init_weights(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    @property
    def device(self) -> torch.device:
        return self.word_embeddings.device

    def init_weights(self, generator: torch.Generator) -> None:
        """normal(0.02) for every weight and embedding (the reference's
        init), zero biases, unit norms."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if "norm" in name:
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                elif name.endswith("bias"):
                    p.zero_()
                else:
                    p.copy_(torch.randn(p.shape, generator=generator) * 0.02)

    def _dropout_generator(self, device, dropout_seed: int):
        gen = self._generators.get(device)
        if gen is None:
            gen = self._generators[device] = torch.Generator(device=device)
        return gen.manual_seed(int(dropout_seed) & ((1 << 63) - 1))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, *,
                deterministic: bool = True, dropout_seed: int = 0,
                masked_positions=None):
        cfg = self.config
        dt = cfg.dtype
        s = input_ids.shape[1]
        x = self.word_embeddings[input_ids.long()]
        x = x + self.position_embeddings[None, :s]
        if token_type_ids is not None:
            x = x + self.token_type_embeddings[token_type_ids.long()]
        # the embedding norm runs in fp32, before the cast
        x = self.embedding_norm(x).to(dt)
        gen = None
        if not deterministic and cfg.hidden_dropout > 0.0:
            gen = self._dropout_generator(x.device, dropout_seed)
            x = hidden_dropout(x, cfg.hidden_dropout, gen)

        # the padding mask as segment ids: pad keys are invisible to real
        # queries (the reference's varlen semantics)
        segment_ids = (attention_mask.to(torch.int32)
                       if attention_mask is not None else None)
        for i, layer in enumerate(self.layers):
            x = layer(x, segment_ids, deterministic,
                      dropout_seed=layer_dropout_seed(dropout_seed, i),
                      generator=gen)

        x_head = x
        if masked_positions is not None:
            idx = masked_positions.long()[..., None].expand(-1, -1,
                                                            x.shape[-1])
            x_head = torch.gather(x, 1, idx)
        hmlm = _gelu(x_head @ self.mlm_dense_weight.to(dt)
                     + self.mlm_dense_bias.to(dt), cfg)
        hmlm = self.mlm_norm(hmlm).to(dt)
        mlm_logits = (hmlm @ self.word_embeddings.to(dt).T
                      + self.mlm_output_bias.to(dt))

        pooled = torch.tanh(x[:, 0, :] @ self.pooler_weight.to(dt)
                            + self.pooler_bias.to(dt))
        nsp_logits = pooled @ self.nsp_weight.to(dt) + self.nsp_bias.to(dt)
        return mlm_logits, nsp_logits


def bert_pretrain_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels):
    """MLM + NSP loss through the fused xentropy kernel, on fp32 logits.
    MLM label 0 marks an unpredicted position (the kernel's padding_idx
    drops it); the MLM loss is the mean over predicted positions, the NSP
    loss the mean over the batch."""
    v = mlm_logits.shape[-1]
    labels = mlm_labels.reshape(-1)
    per_tok = softmax_cross_entropy(mlm_logits.reshape(-1, v).float(),
                                    labels, padding_idx=0)
    denom = torch.clamp((labels != 0).sum(), min=1)
    mlm_loss = per_tok.sum() / denom
    nsp_loss = softmax_cross_entropy(nsp_logits.float(), nsp_labels,
                                     padding_idx=-1).mean()
    return mlm_loss + nsp_loss


def bert_pretrain_loss_fn(model: BertForPreTraining, batch, seed: int):
    """The pretraining loss of one batch with dropout on, as the loss of
    the reference's ``make_pretrain_step``: the gathered MLM head when the
    batch carries ``mlm_positions``. ``seed`` draws the step's dropout."""
    positions = batch.get("mlm_positions")
    mlm_logits, nsp_logits = model(
        batch["input_ids"], batch["token_type_ids"], batch["attention_mask"],
        deterministic=False, dropout_seed=seed, masked_positions=positions)
    labels = (batch["mlm_gathered_labels"] if positions is not None
              else batch["mlm_labels"])
    return bert_pretrain_loss(mlm_logits, nsp_logits, labels,
                              batch["nsp_labels"])


def param_partition_specs(params):
    raise NotImplementedError(_PARTITION)


def synthetic_batch(rng, cfg: BertConfig, batch_size: int, seq_len: int,
                    mlm_fraction: float = 0.15, *,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """Random pretraining batch from the numpy generator ``rng``: the same
    draws in the same order as the reference, so the same seed gives the
    same arrays (int32 tensors on ``device``). Both label views: the dense
    ``mlm_labels`` [B, S] (0 = unpredicted) and ``mlm_positions`` +
    ``mlm_gathered_labels`` [B, K] with K ~ 0.15 S rounded up to a multiple
    of 8."""
    ids = rng.integers(4, cfg.vocab_size, size=(batch_size, seq_len))
    k = min(seq_len, max(8, -(-int(seq_len * mlm_fraction) // 8) * 8))
    positions = np.sort(
        np.argsort(rng.random((batch_size, seq_len)), axis=1)[:, :k], axis=1)
    gathered = np.take_along_axis(ids, positions, axis=1)
    dense = np.zeros_like(ids)
    np.put_along_axis(dense, positions, gathered, axis=1)
    token_types = rng.integers(0, cfg.type_vocab_size,
                               size=(batch_size, seq_len))
    nsp = rng.integers(0, 2, size=(batch_size,))

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(device)

    return {"input_ids": t(ids), "token_type_ids": t(token_types),
            "attention_mask": t(np.ones((batch_size, seq_len))),
            "mlm_labels": t(dense), "mlm_positions": t(positions),
            "mlm_gathered_labels": t(gathered), "nsp_labels": t(nsp)}
