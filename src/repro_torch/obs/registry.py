"""Metric registry — the catalog behind the round telemetry channel,
reference `repro.obs.registry` (numpy only, copied).

Stages emit named values through `RoundContext.record(name, value)`
(`repro_torch.fl.engine`); the value flows out of the round in its
metrics dict, and everything on the host — `History.extra`, the JSONL
trace writer (`obs/trace.py`), `tools/trace_report.py` — finds it by
name. The registry catalogs the names the library stages emit (kind,
emitting stage, one-line doc) so reports can label columns; an
unregistered name is as good as a registered one (`describe` returns a
stub).

`scalar_metrics(metrics)` is the extraction the simulator and the trace
writer share: every 0-d entry of a round's metrics as a Python float
(a 0-d CUDA tensor is read back, which waits for the card).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SCALAR = "scalar"
ARRAY = "array"


@dataclass(frozen=True)
class MetricSpec:
    """One registered metric: its kind, the stage that emits it, docs."""
    name: str
    kind: str = SCALAR              # "scalar" | "array"
    stage: str = ""                 # emitting stage (informational)
    doc: str = ""


@dataclass
class MetricRegistry:
    """Name → MetricSpec catalog. Mutable: subsystems register at import."""
    _specs: dict = field(default_factory=dict)

    def register(self, name: str, *, kind: str = SCALAR, stage: str = "",
                 doc: str = "") -> MetricSpec:
        if kind not in (SCALAR, ARRAY):
            raise ValueError(f"kind must be 'scalar' or 'array', got {kind!r}")
        spec = MetricSpec(name=name, kind=kind, stage=stage, doc=doc)
        self._specs[name] = spec
        return spec

    def describe(self, name: str) -> MetricSpec:
        """Spec for `name`; unregistered names get an undocumented stub
        (recording a new metric never requires registration)."""
        return self._specs.get(name, MetricSpec(name=name, doc="(unregistered)"))

    def names(self, kind: str | None = None) -> tuple:
        return tuple(
            n for n, s in sorted(self._specs.items())
            if kind is None or s.kind == kind
        )

    def __contains__(self, name: str) -> bool:
        return name in self._specs


def scalar_metrics(metrics: dict) -> dict:
    """Every 0-d entry of a round metrics dict as {name: float}.

    Arrays (masks, edges) are skipped — they have dedicated consumers
    (accounting, the selection graph) — and scalars flow through by name,
    so a new `ctx.record` call in any stage reaches the trace with no
    schema edit. Tensors and numpy values alike (`np.ndim` reads a
    tensor's `ndim`)."""
    return {name: float(value) for name, value in metrics.items()
            if np.ndim(value) == 0}


# ---------------------------------------------------------------------------
# the default catalog — what the library stages emit today
# ---------------------------------------------------------------------------

DEFAULT_REGISTRY = MetricRegistry()

for _name, _kind, _stage, _doc in (
    # engine-guaranteed keys (fl.engine.run_round)
    ("active", ARRAY, "participate", "(M,) bool participants this round"),
    ("stale", ARRAY, "participate", "(M,) int32 network staleness lag"),
    ("comm_edges", ARRAY, "plan_exchange", "(M,M) bool p2p pulls"),
    # training stages
    ("train_loss", SCALAR, "local_train", "last-step mean train loss"),
    ("train_loss_e", SCALAR, "phase_e", "Eq. 3 phase-e last-step loss"),
    ("train_loss_h", SCALAR, "phase_h", "Eq. 4 phase-h last-step loss"),
    # PFedDST selection (core.rounds)
    ("select_mask", ARRAY, "update_context", "(M,M) bool peer selection"),
    ("mean_selected_score", SCALAR, "update_context",
     "mean Eq. 9 score over the selected edges"),
    ("s_l_mean", SCALAR, "update_context",
     "mean Eq. 6 loss disparity over the sampled rows"),
    ("s_d_offdiag_mean", SCALAR, "update_context",
     "mean off-diagonal Eq. 7 header cosine"),
    # Eq. 9 decomposition over the selected edges (core.rounds score_select)
    ("sel_s_l_mean", SCALAR, "score_select",
     "mean Eq. 6 loss-disparity component over selected edges"),
    ("sel_s_d_mean", SCALAR, "score_select",
     "mean Eq. 7 header-cosine component over selected edges"),
    ("sel_s_p_mean", SCALAR, "score_select",
     "mean Eq. 8 recency component over selected edges"),
    ("sel_cost_mean", SCALAR, "score_select",
     "mean Eq. 9 link-cost component over selected edges"),
    # hetero / semi-async (fl.hetero)
    ("round_wall_s", SCALAR, "deadline_gate",
     "simulated round duration (deadline-capped)"),
    ("straggler_wall_s", SCALAR, "deadline_gate",
     "slowest sampled client's wall-time"),
    ("eff_lag_mean", SCALAR, "score_select",
     "mean staleness of versions actually pulled"),
    ("eff_lag_max", SCALAR, "score_select",
     "max staleness of versions actually pulled"),
    ("serve_age_mean", SCALAR, "score_select",
     "mean snapshot age over served selected peers"),
    # open-world lifecycle + threat telemetry (the reference's
    # repro.openworld; not ported yet, ROADMAP queue 1 item 11)
    ("alive_frac", SCALAR, "ow_churn",
     "fraction of population slots alive after this round's churn"),
    ("joined_n", SCALAR, "ow_churn", "clients that joined this round"),
    ("left_n", SCALAR, "ow_churn", "clients that left this round"),
    ("adv_active_n", SCALAR, "ow_threat",
     "adversaries in this round's active set"),
    ("adv_edge_frac", SCALAR, "ow_metrics",
     "fraction of honest clients' selected edges hitting adversaries"),
    ("adv_base_frac", SCALAR, "ow_metrics",
     "honest-random baseline adversary fraction of the candidate set"),
    ("adv_isolation", SCALAR, "ow_metrics",
     "1 - adv_edge_frac/adv_base_frac: 1 shunned, 0 random, <0 preferred"),
):
    DEFAULT_REGISTRY.register(_name, kind=_kind, stage=_stage, doc=_doc)
