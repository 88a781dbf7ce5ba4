"""Vocab-parallel cross entropy.

Counterpart of ``apex_tpu/transformer/tensor_parallel/cross_entropy.py``
(plain jnp there, no Pallas kernel, so plain torch here): logits sharded
over the vocab on the tensor-parallel group. The global max (a MAX
all-reduce of the local maxima, carrying no gradient, as in the reference)
shifts the logits; the sum of exponentials and the target's logit, which
exactly one rank owns, are summed over the ranks through
``reduce_from_tensor_model_parallel_region``, whose identity backward makes
autograd give each rank the local softmax minus its owned one-hot, the
reference's backward.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import collectives as coll
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    reduce_from_tensor_model_parallel_region as _allreduce)


def vocab_parallel_cross_entropy(vocab_parallel_logits: torch.Tensor,
                                 target: torch.Tensor,
                                 label_smoothing: float = 0.0,
                                 group=None) -> torch.Tensor:
    """Per-token losses ``[...]`` (fp32) of ``[..., vocab / tp]`` local
    logits against GLOBAL vocab ids ``target [...]``; with
    ``label_smoothing`` the reference's mix with the mean log-probability
    over the full vocab, the smoothing rescaled by ``vocab / (vocab - 1)``.
    """
    if group is None:
        group = parallel_state.get_tensor_model_parallel_group()
    logits = vocab_parallel_logits.float()
    per = logits.shape[-1]
    start = coll.rank(group) * per
    global_max = coll.all_reduce(logits.detach().amax(dim=-1), group, "max")
    shifted = logits - global_max[..., None]
    sum_exp = _allreduce(shifted.exp().sum(dim=-1), group)
    lse = torch.log(sum_exp)
    local_t = target.long() - start
    owned = (local_t >= 0) & (local_t < per)
    t_logit = shifted.gather(-1, local_t.clamp(0, per - 1)[..., None])[..., 0]
    t_logit = _allreduce(torch.where(owned, t_logit, 0.0), group)
    loss = lse - t_logit
    if label_smoothing > 0.0:
        vocab = per * coll.world_size(group)
        smoothing = label_smoothing * vocab / (vocab - 1)
        mean_logprob = _allreduce(shifted.sum(dim=-1), group) / vocab - lse
        loss = (1.0 - smoothing) * loss - smoothing * mean_logprob
    return loss
