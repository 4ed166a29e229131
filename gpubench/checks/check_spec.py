"""BENCHMARK.json against the contract's shape, and every cell,
configuration and metric found by name; a cell added as files alone
runs."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from gpubench.checks import tiny
from gpubench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_found_by_name(entry):
    assert NAME.match(entry["name"])
    assert entry["file"] == f"gpubench/configs/{entry['name']}.json"
    cfg = spec.config(entry["name"])
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert set(entry) == {"name", "source", "file", "reduced", "why"}


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_file_found_by_name(entry):
    assert NAME.match(entry["name"]) and len(entry["why"]) <= 200
    cell = spec.cell(entry["name"])
    assert cell["config"] == entry["config"]
    assert cell["chips"] == entry["chips"] == 1
    e2e = [m["name"] for m in spec.metrics_of(entry["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(entry["name"], "per_layer")
    assert cell["limits"] and set(cell["limits"]) <= {
        "s_l0_gap", "select0_gap", "first_loss_gap", "first_mom_median",
        "mom_median", "delta_median", "unmoved"}


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_reader_found_by_name(entry):
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    assert callable(spec.reader(entry["name"]).read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(entry.get("workloads", cells)) <= cells
    if "bound" in entry:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    else:
        moves = {m["name"]: m for m in BENCH["end_to_end"]}[entry["moves"]]
        for cell in entry["workloads"]:
            assert cell in moves.get("workloads", cells)


def test_no_file_a_bare_pytest_collects():
    for path in spec.BENCH_DIR.rglob("*.py"):
        name = path.name
        assert not name.startswith("test_") and not name.endswith("_test.py")
        assert name != "conftest.py"


def test_cell_added_as_files_alone_runs(tmp_path):
    """A new cell and configuration are two JSON files and entries in
    BENCHMARK.json: found by name and run, no code touched."""
    bench = tmp_path / "gpubench"
    shutil.copytree(spec.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    model = tiny.model("qwen2-1.5b")
    model["name"] = "tiny-qwen2"
    cell = tiny.cell("qwen2-pfeddst")      # another mix: one peer a round
    cell.update(config="tiny-qwen2")
    cell["fl"]["peers_per_round"] = 1
    (bench / "configs" / "tiny-qwen2.json").write_text(json.dumps(model))
    (bench / "workloads" / "tiny-added.json").write_text(json.dumps(cell))
    manifest = json.loads(json.dumps(BENCH))
    manifest["workloads"].append({"name": "tiny-added",
                                  "config": "tiny-qwen2",
                                  "traffic": "tiny-added", "chips": 1,
                                  "why": "added as files"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "qwen2-pfeddst" in m.get("workloads", ["qwen2-pfeddst"]):
            m.setdefault("workloads", []).append("tiny-added")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    found = spec.cell("tiny-added", bench)
    metrics = spec.metrics_of("tiny-added", "end_to_end", tmp_path)
    res = tiny.run("tiny-added", c=found,
                   m=spec.config(found["config"], bench), metrics=metrics)
    assert res["correct"], res["checked"]
    assert {"setup_s", "round_s", "peak_mem_gb"} >= set(res["metrics"])
    assert "setup_s" in res["metrics"] and "round_s" in res["metrics"]
