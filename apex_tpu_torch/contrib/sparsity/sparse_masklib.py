"""2:4 (n:m) structured-sparsity masks.

Counterpart of ``apex_tpu/contrib/sparsity/sparse_masklib.py`` (the
reference's ``apex/contrib/sparsity/sparse_masklib.py``): keep the ``n``
largest magnitudes of every ``m`` consecutive elements along the last
dimension of the tensor as stored, ties going to the earlier element, by
the same pairwise rank (no sort), so the masks equal the reference's
element for element.
"""

from __future__ import annotations

import torch


def _mask_1d_groups(flat: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Keep the ``n`` largest |values| of every ``m`` consecutive elements:
    ``(..., k * m)`` -> a bool mask of the same shape. An element's rank is
    the count of elements of its group that beat it (larger, or equal and
    earlier); it is kept when its rank is below ``n``."""
    mag = flat.reshape(*flat.shape[:-1], -1, m).abs()
    gt = mag[..., None, :] > mag[..., :, None]
    eq = mag[..., None, :] == mag[..., :, None]
    idx = torch.arange(m, device=flat.device)
    earlier = idx[None, :] < idx[:, None]
    rank = (gt | (eq & earlier)).sum(-1)
    return (rank < n).reshape(flat.shape)


def mn_1d_mask(t: torch.Tensor, m: int = 4, n: int = 2) -> torch.Tensor:
    """Pattern ``m4n2_1d``: groups along the LAST dimension."""
    if t.shape[-1] % m != 0:
        raise ValueError(
            f"last dim {t.shape[-1]} not divisible by m={m} "
            "(reference: tensors must be padded or excluded)")
    return _mask_1d_groups(t, m, n)


def create_mask(t: torch.Tensor, pattern: str = "m4n2_1d") -> torch.Tensor:
    """A bool mask with ``pattern`` sparsity: ``m4n2_1d`` and
    ``m4n2_1d_best`` (the same 1-D mask); any other pattern raises
    ``ValueError``, as the reference's."""
    if pattern in ("m4n2_1d", "m4n2_1d_best"):
        return mn_1d_mask(t, 4, 2)
    raise ValueError(f"unsupported sparsity pattern {pattern!r} "
                     "(supported: m4n2_1d)")


def magnitude_retained(t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The share of the total |weight| that the mask keeps."""
    a = t.abs()
    return (a * mask).sum() / torch.clamp(a.sum(), min=1e-30)
