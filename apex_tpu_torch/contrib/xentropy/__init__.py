"""Counterpart of ``apex_tpu.contrib.xentropy``."""

from apex_tpu_torch.contrib.xentropy.softmax_xentropy import (
    SoftmaxCrossEntropyLoss, softmax_cross_entropy_loss)

__all__ = ["SoftmaxCrossEntropyLoss", "softmax_cross_entropy_loss"]
