"""repro_torch.obs — structured round telemetry, reference `repro.obs`.

registry        metric catalog + the generic scalar-metrics extraction
                behind History.extra and the trace writer
trace           schema-versioned per-round JSONL traces: writer, record
                helpers, validator, reader
timers          host-side compile/steady wall-time attribution: per-stage
                instrumentation (fenced by torch.cuda.synchronize),
                whole-round clock, torch.profiler spans
selection_probe opt-in dense Eq. 9 score decomposition, fused-kernel
                parity checks, cumulative selection-graph export

Layering: obs sits above core (the selection probe reuses the scoring
definitions) and below comms/fl — the engine, the simulator and the
serving loop import it; it never imports them.
"""
from repro_torch.obs.registry import (
    DEFAULT_REGISTRY,
    MetricRegistry,
    MetricSpec,
    scalar_metrics,
)
from repro_torch.obs.selection_probe import (
    SelectionGraph,
    check_fused_parity,
    components_of_selected,
    decompose_scores,
    probe_topk,
)
from repro_torch.obs.timers import (
    RoundClock,
    StageTimes,
    annotate,
    instrument_stages,
    stage_name,
)
from repro_torch.obs.trace import (
    SCHEMA_VERSION,
    TraceWriter,
    header_record,
    read_trace,
    round_record,
    score_block,
    stage_profile_record,
    summary_record,
    validate_record,
    validate_trace,
)

__all__ = [
    "DEFAULT_REGISTRY",
    "MetricRegistry",
    "MetricSpec",
    "scalar_metrics",
    "SelectionGraph",
    "check_fused_parity",
    "components_of_selected",
    "decompose_scores",
    "probe_topk",
    "RoundClock",
    "StageTimes",
    "annotate",
    "instrument_stages",
    "stage_name",
    "SCHEMA_VERSION",
    "TraceWriter",
    "header_record",
    "read_trace",
    "round_record",
    "score_block",
    "stage_profile_record",
    "summary_record",
    "validate_record",
    "validate_trace",
]
