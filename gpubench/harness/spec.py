"""Finding a cell's files by name: `workloads/<cell>.json`,
`configs/<config>.json`, `metrics/<metric>.py`, and the cell's metrics
in `BENCHMARK.json` (an entry with a "workloads" list is reported only
in those cells)."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    path = bench_dir / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no cell file {path}")
    return load_json(path)


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "configs" / f"{name}.json")


def metrics_of(cell_name: str, kind: str, root: Path = ROOT) -> list:
    """The BENCHMARK.json entries of `kind` ("end_to_end" or "per_layer")
    this cell reports."""
    bench = load_json(root / "BENCHMARK.json")
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    """metrics/<metric>.py as a module: its `read(record) -> number |
    None` and, where it has them, the `KERNELS` it times."""
    path = bench_dir / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"gpubench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
