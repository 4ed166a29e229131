"""Round-trace JSONL — schema, writer, validator, reader; reference
`repro.obs.trace` (copied: the same schema v1, so a trace the port
writes passes the reference's `validate_trace` and
`tools/trace_report.py --validate`).

One traced experiment = one JSONL file: a `header` record, an optional
`stage_profile` record (eager per-stage compile/steady walls from
obs/timers), one `round` record per executed round, an optional
`selection_graph` record (cumulative peer-selection frequencies from
obs/selection_probe), and a closing `summary`. The schema is versioned
(`SCHEMA_VERSION`, stamped into the header) so downstream consumers —
`tools/trace_report.py`, a CI artifact check — can rely on it.

Record shapes (all extra keys allowed; required keys validated):

  header           type, schema, strategy, num_clients, num_rounds
  stage_profile    type, stages: {name: {first_s, steady_s, compile_s,
                   calls}}
  round            type, round, wall_s, compile (bool: round 0 pays the
                   jit tax), active, stale_mean, stale_max,
                   comm {bytes, net_time_s, energy_j},
                   device {wall_s, straggler_s, eff_lag},
                   metrics {name: float}   — every recorded scalar,
                   score {s_l, s_d, s_p, cost, total} | absent — the
                   Eq. 9 decomposition means over selected edges,
                   edges [[i, j], ...] | absent — the selected pairs,
                   eval {accuracy, train_loss} | absent
  selection_graph  type, num_clients, rounds, edges [[i, j, count]...],
                   churn [float]  — per-round selection Jaccard churn
  summary          type, rounds, wall_s, compile_s
"""
from __future__ import annotations

import json
import sys

import numpy as np

SCHEMA_VERSION = 1

# required keys per record type (extra keys always allowed)
REQUIRED = {
    "header": ("type", "schema", "strategy", "num_clients", "num_rounds"),
    "stage_profile": ("type", "stages"),
    "round": ("type", "round", "wall_s", "compile", "active",
              "stale_mean", "stale_max", "comm", "device", "metrics"),
    "selection_graph": ("type", "num_clients", "rounds", "edges"),
    "summary": ("type", "rounds", "wall_s", "compile_s"),
}
# the Eq. 9 decomposition block, when present
SCORE_KEYS = ("s_l", "s_d", "s_p", "cost", "total")
COMM_KEYS = ("bytes", "net_time_s", "energy_j")
DEVICE_KEYS = ("wall_s", "straggler_s", "eff_lag")


def _jsonable(value):
    """torch/numpy scalars and arrays → plain Python for json.dumps. (torch
    is looked up, not imported: a process that has not imported it holds
    no tensor, and `repro_torch.tools.trace_report` reads this module
    without it.)"""
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    arr = np.asarray(value)
    if arr.ndim == 0:
        if arr.dtype.kind == "b":
            return bool(arr)
        if arr.dtype.kind in "iu":
            return int(arr)
        return float(arr)
    return _jsonable(arr.tolist())


class TraceWriter:
    """Streaming JSONL trace writer (one json.dumps + flush per record).

    Context-manager friendly; `write` stamps nothing — callers build
    records via the helpers below so required keys are always present.
    """

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "w")
        self.records = 0

    def write(self, record: dict):
        record = _jsonable(record)      # torch/numpy scalars → plain Python
        errors = validate_record(record)
        if errors:
            raise ValueError(
                f"invalid trace record ({record.get('type')!r}): {errors}"
            )
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        self.records += 1

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# record constructors
# ---------------------------------------------------------------------------

def header_record(*, strategy: str, num_clients: int, num_rounds: int,
                  **extra) -> dict:
    return {"type": "header", "schema": SCHEMA_VERSION, "strategy": strategy,
            "num_clients": int(num_clients), "num_rounds": int(num_rounds),
            **extra}


def stage_profile_record(stage_summary: dict) -> dict:
    """stage_summary: obs.timers.StageTimes.summary()."""
    return {"type": "stage_profile", "stages": stage_summary}


def round_record(*, rnd: int, wall_s: float, compile_round: bool,
                 active: int, stale_mean: float, stale_max: int,
                 comm: dict, device: dict, metrics: dict,
                 score: dict | None = None, edges=None,
                 eval_point: dict | None = None) -> dict:
    rec = {
        "type": "round", "round": int(rnd), "wall_s": float(wall_s),
        "compile": bool(compile_round), "active": int(active),
        "stale_mean": float(stale_mean), "stale_max": int(stale_max),
        "comm": comm, "device": device, "metrics": metrics,
    }
    if score is not None:
        rec["score"] = score
    if edges is not None:
        rec["edges"] = edges
    if eval_point is not None:
        rec["eval"] = eval_point
    return rec


def score_block(metrics: dict) -> dict | None:
    """Assemble the Eq. 9 decomposition block from the recorded
    `sel_*_mean` metrics (core.rounds score_select); None when the
    strategy does not score (the non-PFedDST baselines)."""
    mapping = {"s_l": "sel_s_l_mean", "s_d": "sel_s_d_mean",
               "s_p": "sel_s_p_mean", "cost": "sel_cost_mean",
               "total": "mean_selected_score"}
    if not all(k in metrics for k in mapping.values()):
        return None
    return {out: float(metrics[src]) for out, src in mapping.items()}


def summary_record(*, rounds: int, wall_s: float, compile_s: float,
                   **extra) -> dict:
    return {"type": "summary", "rounds": int(rounds),
            "wall_s": float(wall_s), "compile_s": float(compile_s), **extra}


# ---------------------------------------------------------------------------
# validation / reading
# ---------------------------------------------------------------------------

def validate_record(record: dict) -> list:
    """→ list of error strings (empty = valid)."""
    errors = []
    rtype = record.get("type")
    if rtype not in REQUIRED:
        return [f"unknown record type {rtype!r}"]
    for key in REQUIRED[rtype]:
        if key not in record:
            errors.append(f"{rtype}: missing key {key!r}")
    if rtype == "header" and record.get("schema") != SCHEMA_VERSION:
        errors.append(
            f"header: schema {record.get('schema')!r} != {SCHEMA_VERSION}"
        )
    if rtype == "round":
        for block, keys in (("comm", COMM_KEYS), ("device", DEVICE_KEYS)):
            sub = record.get(block)
            if not isinstance(sub, dict):
                errors.append(f"round: {block} must be a dict")
                continue
            errors.extend(
                f"round: {block} missing {k!r}" for k in keys if k not in sub
            )
        if "score" in record:
            errors.extend(
                f"round: score missing {k!r}"
                for k in SCORE_KEYS if k not in record["score"]
            )
        metrics = record.get("metrics")
        if isinstance(metrics, dict):
            bad = [k for k, v in metrics.items()
                   if not isinstance(v, (int, float))]
            if bad:
                errors.append(f"round: non-scalar metrics {bad}")
        elif metrics is not None:
            errors.append("round: metrics must be a dict")
    return errors


def read_trace(path: str) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def validate_trace(path: str) -> tuple:
    """→ (records, errors). Checks every record plus file-level shape:
    exactly one header (first), round indices strictly increasing."""
    records = read_trace(path)
    errors = []
    if not records:
        return records, ["empty trace"]
    if records[0].get("type") != "header":
        errors.append("first record must be a header")
    if sum(r.get("type") == "header" for r in records) != 1:
        errors.append("trace must contain exactly one header")
    for i, rec in enumerate(records):
        errors.extend(f"record {i}: {e}" for e in validate_record(rec))
    rounds = [r["round"] for r in records
              if r.get("type") == "round" and "round" in r]
    if rounds != sorted(set(rounds)):
        errors.append("round indices must be strictly increasing")
    return records, errors
