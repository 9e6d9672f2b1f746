"""Fixed-capacity stream compaction (counterpart of `oxylus_tpu/ops/compact.py`).

Mask → cumsum → unique-index scatter into a fixed-capacity buffer + a count, so
no step reads a size back to the host. Overflow drops.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def masked_compact(mask: Tensor, capacity: int) -> tuple[Tensor, Tensor, Tensor]:
    """Indices of the true entries of `mask` (N,) in a (capacity,) buffer.

    Returns (indices (capacity,) i32 — source index per slot, 0 past count;
             valid (capacity,) bool; count () i32 clamped to capacity)."""
    n = mask.shape[0]
    slots = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    # slot `capacity` is the dump for dropped and masked-out entries
    target = torch.where(mask & (slots < capacity), slots, capacity).long()
    src = torch.arange(n, dtype=torch.int32, device=mask.device)
    out = torch.zeros(capacity + 1, dtype=torch.int32, device=mask.device).scatter_(0, target, src)[:capacity]
    count = torch.clamp(mask.sum(dtype=torch.int32), max=capacity)
    valid = torch.arange(capacity, device=mask.device) < count
    return out, valid, count


def prefix_expand(counts: Tensor, capacity: int) -> tuple[Tensor, Tensor, Tensor]:
    """Expand variable-length groups into flat slots (gather-only): for each slot
    s < capacity, (group, rank in group, valid)."""
    prefix = torch.cumsum(counts, 0, dtype=torch.int32)
    total = torch.clamp(prefix[-1], max=capacity)
    s = torch.arange(capacity, dtype=torch.int32, device=counts.device)
    group = torch.searchsorted(prefix, s, right=True).to(torch.int32)
    group_c = torch.clamp(group, 0, counts.shape[0] - 1).long()
    start = prefix[group_c] - counts[group_c]
    rank = s - start
    valid = s < total
    return group_c.to(torch.int32), rank, valid
