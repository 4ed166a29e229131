"""Initial parameters drawn by the benchmark from the seed.

Every (client, leaf) has a generator of its own, seeded from (seed,
client, leaf name), so a leaf can be drawn again later, alone, to read
how far training moved it. Leaves are drawn on the device in the dtype
they are trained in, one call each (stacked layers together)."""
from __future__ import annotations

import zlib

import numpy as np
import torch

SALT = 0x5EED


def leaf_seed(seed: int, client: int, name: str) -> int:
    words = [seed & 0xFFFFFFFF, seed >> 32, SALT, client,
             zlib.crc32(name.encode())]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               >> 1)


def draw_leaf(seed: int, client: int, name: str, spec, dtype, device):
    shape, (kind, value) = spec
    if kind == "const":
        return torch.full(shape, value, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(
        leaf_seed(seed, client, name))
    x = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return x.mul_(value)


def draw_client(seed: int, client: int, specs: dict, dtype, device) -> dict:
    return {name: draw_leaf(seed, client, name, spec, dtype, device)
            for name, spec in specs.items()}
