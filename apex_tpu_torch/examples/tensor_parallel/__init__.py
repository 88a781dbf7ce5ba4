"""Tensor-parallel GPT-2 over torch.distributed."""
