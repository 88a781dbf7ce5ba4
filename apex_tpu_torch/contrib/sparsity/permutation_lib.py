"""Channel-permutation search for 2:4 sparsity.

Counterpart of ``apex_tpu/contrib/sparsity/permutation_lib.py``: permuting
a weight's columns before masking can keep more magnitude under the 2:4
constraint. The reference's greedy pair-swap search, in which each sweep
scores every swap of two columns of different groups at once (a ``[C, C]``
delta matrix from the groups' retained magnitudes), applies the best and
repeats while one helps, becomes a Python loop on the tensor's device (the
reference's ``lax.while_loop``), and the argmax keeps the first maximum,
as JAX's does. The search accepts any gain above 1e-7, rounding noise
included, so where the sums are exact (weights on a dyadic grid) the
permutation is the reference's; on other fp32 data a swap whose gain is
rounding noise may differ, and the retained magnitude agrees.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.contrib.sparsity.sparse_masklib import mn_1d_mask

#: elements of the largest ``[rows, i, C, 4]`` candidate table built at once
_CHUNK_ELEMENTS = 1 << 24


def _top2_row_sum(groups: torch.Tensor) -> torch.Tensor:
    """``[rows, ..., 4]`` -> the 2 largest of each group of 4, summed over
    rows and the pair."""
    return torch.sort(groups, dim=-1).values[..., 2:].sum(dim=(0, -1))


def _retained_per_group(w_abs: torch.Tensor) -> torch.Tensor:
    """``[rows, C]`` -> the top-2 magnitude of each group of 4 columns
    summed over rows, ``[C / 4]``."""
    return _top2_row_sum(w_abs.reshape(w_abs.shape[0], -1, 4))


def _swap_delta_matrix(w_abs: torch.Tensor) -> torch.Tensor:
    """``delta[i, j]``: the retained-magnitude gain of swapping columns i
    and j; -inf within a group."""
    rows, c = w_abs.shape
    gid = torch.arange(c, device=w_abs.device) // 4
    base = _retained_per_group(w_abs)
    groups = w_abs.reshape(rows, -1, 4)
    chunk = max(1, _CHUNK_ELEMENTS // (rows * c * 4))
    repl = []
    for i0 in range(0, c, chunk):
        i = torch.arange(i0, min(c, i0 + chunk), device=w_abs.device)
        # [rows, i, j, 4]: i's group with i's slot holding column j
        cand = groups[:, gid[i]][:, :, None, :].repeat(1, 1, c, 1)
        slot = (i % 4)[None, :, None, None].expand(rows, -1, c, 1)
        cand.scatter_(3, slot, w_abs[:, None, :, None].expand(
            -1, len(i), -1, 1))
        repl.append(_top2_row_sum(cand))
    repl = torch.cat(repl)
    delta = repl + repl.T - base[gid][:, None] - base[gid][None, :]
    return torch.where(gid[:, None] == gid[None, :], -torch.inf, delta)


def search_permutation(w: torch.Tensor, max_swaps: int = 64):
    """Greedy column-swap search maximising the 2:4 retained magnitude of
    ``w`` ``(rows, C)``, C % 4 == 0. Returns ``(perm [C], score)``: ``w[:,
    perm]`` keeps at least as much magnitude under ``m4n2_1d`` as ``w``;
    the search stops when no swap gains more than 1e-7, or after
    ``max_swaps`` sweeps."""
    c = w.shape[1]
    w_abs = w.abs().float()
    perm = torch.arange(c, device=w.device)
    for _ in range(max_swaps):
        delta = _swap_delta_matrix(w_abs)
        flat = int(torch.argmax(delta))
        i, j = flat // c, flat % c
        if not float(delta[i, j]) > 1e-7:
            break
        perm[[i, j]] = perm[[j, i]]
        w_abs[:, [i, j]] = w_abs[:, [j, i]]
    return perm, _retained_per_group(w_abs).sum()


def apply_permutation_and_mask(w: torch.Tensor, perm: torch.Tensor):
    """Permute the columns, mask 2:4, and un-permute: the mask in the
    original column order (the reference folds the permutation into the
    layer upstream instead; un-permuting keeps a drop-in weight mask)."""
    mask_p = mn_1d_mask(w[:, perm])
    return mask_p[:, torch.argsort(perm)]
