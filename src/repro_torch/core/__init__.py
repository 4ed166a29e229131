"""PFedDST core of the port — reference `repro.core`.

scoring        — Eq. 6 (loss disparity), Eq. 7 (header cosine), Eq. 8
                 (recency)
selection      — Eq. 9 combination + top-k / threshold peer choice
aggregation    — masked extractor averaging across the client axis
partial_freeze — Eq. 3/4 two-phase (e-then-h) frozen training steps
rounds         — the full Algorithm 1 round over the population
client_state   — the per-client context arrays (loss l, recency t)
"""
from repro_torch.core.aggregation import (
    aggregate_extractors,
    selection_to_weights,
)
from repro_torch.core.client_state import PopulationState, init_population
from repro_torch.core.partial_freeze import make_phase_steps
from repro_torch.core.scoring import (
    header_distance_matrix,
    recency_scores,
)
# the reference's full O(M²) Eq. 6 matrix is the rows form over every
# client
from repro_torch.core.scoring import (
    loss_disparity_rows as loss_disparity_matrix,
)
from repro_torch.core.selection import (
    as_cost_matrix,
    combined_scores,
    select_peers,
    update_recency,
)


def __getattr__(name):
    # rounds builds on repro_torch.fl.engine, which imports
    # repro_torch.core.*: a lazy export keeps
    # `from repro_torch.core import pfeddst_round` free of the cycle
    if name in ("pfeddst_round", "make_pfeddst_stages", "PFEDDST_STREAMS"):
        from repro_torch.core import rounds

        return getattr(rounds, name)
    raise AttributeError(
        f"module 'repro_torch.core' has no attribute {name!r}")


__all__ = [
    "header_distance_matrix",
    "loss_disparity_matrix",
    "recency_scores",
    "as_cost_matrix",
    "combined_scores",
    "select_peers",
    "update_recency",
    "aggregate_extractors",
    "selection_to_weights",
    "make_phase_steps",
    "PopulationState",
    "init_population",
    "pfeddst_round",
]
