"""Seed streams for init-time use (reference `repro.utils.prng`).

The reference splits a threefry key (`jax.random.split`); torch has no
threefry, so the port cannot give the same bits. `KeySeq` keeps the
contract instead: every `next(seq)` and every entry of `take(n)` is a
fresh CPU `torch.Generator`, seeded from an `np.random.SeedSequence`
child of the seed (as `fl.engine.named_streams` seeds its streams), so
a sequence is a function of its seed alone and its generators draw
independent streams. The tests hold it to determinism and independence,
not to the reference's bits.
"""
from __future__ import annotations

import numpy as np
import torch


class KeySeq:
    """Stateful (python-level) generator sequence for init-time use.

    `seed_or_seq`: an int seed or an `np.random.SeedSequence` (the
    counterpart of the reference's key)."""

    def __init__(self, seed_or_seq):
        if isinstance(seed_or_seq, np.random.SeedSequence):
            self._seq = seed_or_seq
        else:
            self._seq = np.random.SeedSequence(int(seed_or_seq))

    def __next__(self) -> torch.Generator:
        return self.take(1)[0]

    def take(self, n: int) -> list:
        """n fresh generators, each from its own SeedSequence child."""
        out = []
        for child in self._seq.spawn(n):
            seed = child.generate_state(1, np.uint64)[0]
            out.append(torch.Generator().manual_seed(int(seed)))
        return out
