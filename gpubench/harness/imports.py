"""What a run may not load: JAX and the JAX package the port was made
from. Module names are compared by their top-level name, whole
(`repro_torch` is the port, `repro` is not)."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None) -> list:
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(n for n in names if n in FORBIDDEN)
