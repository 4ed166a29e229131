"""Render a round trace (JSONL, schema v1) as terminal tables — the twin
of the reference's `tools/trace_report.py`, for traces the port writes
(`run_experiment(trace=)`) or the reference's.

    python -m repro_torch.tools.trace_report TRACE.jsonl
    python -m repro_torch.tools.trace_report TRACE.jsonl --validate

Sections (each skipped when the trace lacks the records that feed it):
  * run header — strategy, population, schema version
  * per-stage compile/steady wall table (the `stage_profile` record)
  * round table — wall, active, comm bytes/net time, stale lag
  * Eq. 9 score decomposition — per-component mean over traced rounds
    plus first→last drift (is selection converging on loss-disparate,
    dissimilar peers as the paper argues?)
  * selection graph — top selected edges by frequency, mean churn

--validate re-checks every record against the obs.trace schema and
exits nonzero on any error (the CI artifact gate).

The schema (`SCORE_KEYS`, `validate_trace`) is read from
`repro_torch/obs/trace.py`, loaded by its path: the `repro_torch.obs`
package's `__init__` (the selection probe and the stage timers, which
import torch) is never imported.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path


def _load_trace():
    path = Path(__file__).resolve().parent.parent / "obs" / "trace.py"
    spec = importlib.util.spec_from_file_location("_repro_torch_trace",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_trace = _load_trace()
SCORE_KEYS, validate_trace = _trace.SCORE_KEYS, _trace.validate_trace


def _fmt_row(cells, widths):
    return "  ".join(str(c).rjust(w) for c, w in zip(cells, widths))


def _table(headers, rows):
    widths = [
        max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows
        else len(str(h))
        for i, h in enumerate(headers)
    ]
    lines = [_fmt_row(headers, widths),
             _fmt_row(["-" * w for w in widths], widths)]
    lines += [_fmt_row(r, widths) for r in rows]
    return "\n".join(lines)


def report(records) -> str:
    by_type: dict = {}
    for rec in records:
        by_type.setdefault(rec.get("type"), []).append(rec)
    out = []

    for hdr in by_type.get("header", [])[:1]:
        out.append(
            f"trace: strategy={hdr['strategy']} "
            f"M={hdr['num_clients']} rounds={hdr['num_rounds']} "
            f"schema=v{hdr['schema']}"
        )

    for prof in by_type.get("stage_profile", [])[:1]:
        rows = [
            [name, f"{s['steady_s']:.4f}", f"{s['compile_s']:.4f}",
             f"{s['first_s']:.4f}", s["calls"]]
            for name, s in prof["stages"].items()
        ]
        rows.sort(key=lambda r: -float(r[1]))
        out.append("\nper-stage wall (eager instrumented rounds):")
        out.append(_table(
            ["stage", "steady_s", "compile_s", "first_s", "calls"], rows
        ))

    rounds = by_type.get("round", [])
    if rounds:
        rows = []
        for r in rounds:
            acc = r.get("eval", {}).get("accuracy")
            rows.append([
                r["round"], "c" if r["compile"] else "",
                f"{r['wall_s']:.3f}", r["active"],
                f"{r['comm']['bytes'] / 1e6:.2f}",
                f"{r['comm']['net_time_s']:.2f}",
                f"{r['stale_mean']:.2f}",
                f"{acc:.4f}" if acc is not None else "",
            ])
        out.append("\nrounds (c = compile round):")
        out.append(_table(
            ["round", "", "wall_s", "active", "MB", "net_s",
             "stale", "acc"], rows,
        ))

        scored = [r for r in rounds if "score" in r]
        if scored:
            rows = []
            for key in SCORE_KEYS:
                vals = [r["score"][key] for r in scored]
                rows.append([
                    key, f"{sum(vals) / len(vals):.4f}",
                    f"{vals[0]:.4f}", f"{vals[-1]:.4f}",
                    f"{vals[-1] - vals[0]:+.4f}",
                ])
            out.append(
                "\nEq. 9 decomposition, mean over selected edges "
                f"({len(scored)} scored rounds):"
            )
            out.append(_table(
                ["component", "mean", "first", "last", "drift"], rows
            ))

    for g in by_type.get("selection_graph", [])[:1]:
        churn = g.get("churn", [])
        mean_churn = sum(churn) / len(churn) if churn else 0.0
        out.append(
            f"\nselection graph: {len(g['edges'])} distinct edges over "
            f"{g['rounds']} rounds, mean churn {mean_churn:.3f}"
        )
        rows = [[i, j, c, f"{c / max(g['rounds'], 1):.2f}"]
                for i, j, c in g["edges"][:10]]
        out.append(_table(["i", "j", "count", "freq"], rows))

    for s in by_type.get("summary", [])[:1]:
        out.append(
            f"\nsummary: {s['rounds']} rounds, steady wall "
            f"{s['wall_s']:.2f}s, compile {s['compile_s']:.2f}s"
        )
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="JSONL trace from a traced experiment")
    ap.add_argument("--validate", action="store_true",
                    help="exit nonzero if any record fails the schema")
    args = ap.parse_args(argv)

    records, errors = validate_trace(args.trace)
    if args.validate and errors:
        for e in errors:
            print(f"SCHEMA ERROR: {e}", file=sys.stderr)
        return 1
    print(report(records))
    if errors:
        print(f"\n({len(errors)} schema errors — rerun with --validate "
              "to fail on them)", file=sys.stderr)
    if args.validate:
        print(f"\ntrace OK: {len(records)} records, schema valid")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
