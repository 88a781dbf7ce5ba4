"""Flattened parameter buffers: the layout of the fused optimizer kernels.

The port's copy of ``apex_tpu/ops/flat_buffer.py``. Every tensor of a
named list is padded to whole rows of ``LANE`` elements and the rows are
stacked into one ``(total_rows, LANE)`` buffer, so one kernel launch updates
every parameter of a network and each row belongs to exactly one tensor
(``FlatSpec.segment_rows``). The row width stays the reference's, so the
two packages lay a network out the same way and a per-tensor vector indexes
the same segments.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import torch

LANE = 1024  # elements per row, as in the reference

Named = Iterable[Tuple[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static layout of a flattened list of named tensors."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]          # unpadded element counts
    row_offsets: Tuple[int, ...]    # starting row of each tensor
    row_counts: Tuple[int, ...]     # rows occupied by each tensor
    total_rows: int

    @property
    def num_tensors(self) -> int:
        return len(self.shapes)

    @property
    def total_elements(self) -> int:
        return self.total_rows * LANE

    def segment_rows(self) -> torch.Tensor:
        """int32 ``(total_rows,)`` mapping each row to its tensor index."""
        return torch.repeat_interleave(
            torch.arange(self.num_tensors, dtype=torch.int32),
            torch.tensor(self.row_counts, dtype=torch.int64))


def build_spec(tensors: Named) -> FlatSpec:
    """The layout of ``(name, tensor)`` pairs, in their order."""
    names, shapes, sizes, offsets, counts = [], [], [], [], []
    row = 0
    for name, t in tensors:
        n = t.numel()
        rows = max(1, -(-n // LANE))
        names.append(name)
        shapes.append(tuple(t.shape))
        sizes.append(n)
        offsets.append(row)
        counts.append(rows)
        row += rows
    return FlatSpec(names=tuple(names), shapes=tuple(shapes),
                    sizes=tuple(sizes),
                    row_offsets=tuple(offsets), row_counts=tuple(counts),
                    total_rows=row)


def flatten(tensors: Named, spec: FlatSpec) -> torch.Tensor:
    """Copy the tensors into one zero-padded fp32 ``(total_rows, LANE)``
    buffer on the first tensor's device."""
    items = list(tensors)
    device = items[0][1].device if items else None
    flat = torch.zeros(spec.total_rows, LANE, dtype=torch.float32,
                       device=device)
    for (_, t), n, off in zip(items, spec.sizes, spec.row_offsets):
        flat.view(-1)[off * LANE:off * LANE + n].copy_(t.reshape(-1))
    return flat


def unflatten(flat: torch.Tensor, spec: FlatSpec) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of the original shapes, each a VIEW into ``flat``
    (writes go through)."""
    return {name: flat.view(-1)[off * LANE:off * LANE + n].view(shape)
            for name, shape, n, off in zip(spec.names, spec.shapes,
                                           spec.sizes, spec.row_offsets)}
