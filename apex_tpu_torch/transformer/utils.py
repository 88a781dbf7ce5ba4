"""Utilities of ``apex_tpu/transformer/utils.py``: ``ensure_divisibility``,
``divide`` and ``split_tensor_along_last_dim``."""

from __future__ import annotations

import torch


def ensure_divisibility(numerator: int, denominator: int) -> None:
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(tensor: torch.Tensor, num_partitions: int):
    """``num_partitions`` equal views of ``tensor`` along its last dim (a
    tuple)."""
    chunk = divide(tensor.shape[-1], num_partitions)
    return tuple(torch.split(tensor, chunk, dim=-1))
