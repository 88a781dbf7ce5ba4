"""Memory-saving label-smoothed cross entropy, with the call surface of the
reference's ``SoftmaxCrossEntropyLoss`` autograd Function.

Counterpart of ``apex_tpu/contrib/xentropy/softmax_xentropy.py``; the
kernel is ``apex_tpu_torch/ops/xentropy.py`` (it saves only the LSE and
recomputes the softmax in the backward).
"""

from __future__ import annotations

from apex_tpu_torch.ops.xentropy import softmax_cross_entropy


class SoftmaxCrossEntropyLoss:
    """``SoftmaxCrossEntropyLoss.apply(logits, labels, smoothing=0.0,
    padding_idx=0, half_to_float=False)`` returns the per-row losses,
    differentiable in the logits. The losses are fp32; unless
    ``half_to_float``, they come back in the logits' dtype, as the
    reference keeps 16-bit losses for 16-bit logits."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=0,
              half_to_float=False):
        losses = softmax_cross_entropy(logits, labels, smoothing=smoothing,
                                       padding_idx=padding_idx)
        if not half_to_float and losses.dtype != logits.dtype:
            losses = losses.to(logits.dtype)
        return losses

    def __call__(self, logits, labels, smoothing=0.0, padding_idx=0,
                 half_to_float=False):
        return self.apply(logits, labels, smoothing, padding_idx,
                          half_to_float)


def softmax_cross_entropy_loss(logits, labels, smoothing=0.0, padding_idx=0,
                               half_to_float=False):
    return SoftmaxCrossEntropyLoss.apply(logits, labels, smoothing,
                                         padding_idx, half_to_float)
