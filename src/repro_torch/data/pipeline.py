"""Batching — random index batches per client, reference
`repro.data.pipeline`.

Draws come from CPU torch.Generators, so a run's choices do not depend on
the device; the index tensors move to the data's device. Every sampler
takes an optional precomputed `idx` — the randomness hook through which
a caller (the parity tests) injects the reference's draws.
"""
from __future__ import annotations

import numpy as np
import torch


def as_index_tensor(a, device=None) -> torch.Tensor:
    """Indices (a tensor, or an array from outside the port) as int64 on
    `device`; arrays are copied, so read-only buffers are fine."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=torch.int64)


def sample_client_indices(generator: torch.Generator, m: int, n: int,
                          batch_size: int, *, rows=None,
                          total: int | None = None):
    """(M', B) batch indices, one independent batch per client, drawn
with replacement (streaming semantics).

    rows/total: active-subset mode — the draw covers all `total` clients
    of the population and keeps `rows`, so client i gets the batch it
    would have drawn in the full population (the reference's positional
    keying of `sample_client_batches`)."""
    if rows is None:
        return torch.randint(0, n, (m, batch_size), generator=generator)
    full = torch.randint(0, n, (total, batch_size), generator=generator)
    return full[as_index_tensor(rows)]


def take_client_batches(stacked: dict, idx) -> dict:
    """stacked: dict of (M', N, ...) tensors, idx (M', B) → (M', B, ...)."""
    first = next(iter(stacked.values()))
    idx = as_index_tensor(idx, first.device)
    rows = torch.arange(idx.shape[0], device=first.device)[:, None]
    return {k: v[rows, idx] for k, v in stacked.items()}


def sample_client_batches(generator: torch.Generator, stacked: dict,
                          batch_size: int, *, rows=None,
                          total: int | None = None, idx=None) -> dict:
    """stacked: dict of (M', N, ...) tensors → dict of (M', B, ...)
    batches. `idx` (M', B), when given, replaces the draw."""
    if idx is None:
        first = next(iter(stacked.values()))
        idx = sample_client_indices(generator, first.shape[0],
                                    first.shape[1], batch_size, rows=rows,
                                    total=total)
    return take_client_batches(stacked, idx)
