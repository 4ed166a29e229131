"""The port's observability layer (`repro_torch.obs`) against the JAX
reference's `repro.obs`: the metric registry, the schema-v1 round trace
(writer, record constructors, validators), the stage timers, the selection
probe; and `run_experiment(trace=...)` writing a trace the reference's
validator and `tools/trace_report.py --validate` accept unchanged, whose
round records equal the run's `History`.

The registry, trace and selection-graph code is a copy of numpy-only
reference modules: equal outputs. The selection probe's scores are the
dense plain Eq. 9 on both sides, in float32 sums of different order:
indices exactly, values at atol 1e-5 (the reference's own tolerance).
"""
import dataclasses
import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.core.scoring import score_topk as ref_score_topk
from repro_torch import obs
from repro_torch.configs import (CommsConfig, DeviceProfile, FLConfig,
                                 get_config)
from repro_torch.core.scoring import selected_components
from repro_torch.core.selection import NEG
from repro_torch.data.synthetic import client_datasets_cifar
from repro_torch.fl import simulator
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parent.parent


def _trace_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report", ROOT / "tools" / "trace_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_equals_reference():
    assert obs.DEFAULT_REGISTRY.names() == ref_obs.DEFAULT_REGISTRY.names()
    for name in ref_obs.DEFAULT_REGISTRY.names():
        assert obs.DEFAULT_REGISTRY.describe(name) == \
            obs.MetricSpec(**dataclasses.asdict(
                ref_obs.DEFAULT_REGISTRY.describe(name))), name
    for kind in ("scalar", "array"):
        assert obs.DEFAULT_REGISTRY.names(kind) == \
            ref_obs.DEFAULT_REGISTRY.names(kind)
    reg = obs.MetricRegistry()
    reg.register("x", stage="s", doc="d")
    assert "x" in reg and "y" not in reg
    assert reg.describe("y").doc == "(unregistered)"
    with pytest.raises(ValueError):
        reg.register("z", kind="tensor")
    for name in ("round_wall_s", "straggler_wall_s", "eff_lag_mean",
                 "eff_lag_max", "serve_age_mean"):
        assert name in obs.DEFAULT_REGISTRY


def test_scalar_metrics_equal_reference():
    """0-d tensors of every dtype, numpy scalars and Python numbers pass;
    arrays do not; the floats equal the reference's on the same values."""
    rng = np.random.default_rng(0)
    vals = {"a": np.float32(rng.random()), "b": np.int32(3), "c": 2.5,
            "d": True, "mask": rng.random((3, 3)) > 0.5,
            "v": rng.random(4).astype(np.float32)}
    got = obs.scalar_metrics({
        **{k: torch.as_tensor(v) for k, v in vals.items()}, "py": 7})
    want = ref_obs.scalar_metrics({
        **{k: jnp.asarray(v) for k, v in vals.items()}, "py": 7})
    assert got == want
    assert set(got) == {"a", "b", "c", "d", "py"}


# ---------------------------------------------------------------------------
# the trace schema
# ---------------------------------------------------------------------------

def _round(mod, rnd=0, **kw):
    base = dict(rnd=rnd, wall_s=0.1, compile_round=(rnd == 0), active=4,
                stale_mean=0.0, stale_max=0,
                comm={"bytes": 10, "net_time_s": 0.1, "energy_j": 0.2},
                device={"wall_s": 0.0, "straggler_s": 0.0, "eff_lag": 0.0},
                metrics={"train_loss": 1.0})
    base.update(kw)
    return mod.round_record(**base)


def test_trace_writer_roundtrip_read_by_the_reference(tmp_path):
    """Tensors (0-d and arrays, any dtype) become plain JSON; the file
    reads back equal and passes both validators."""
    path = str(tmp_path / "t.jsonl")
    with obs.TraceWriter(path) as tw:
        tw.write(obs.header_record(strategy="pfeddst", num_clients=8,
                                   num_rounds=2, seed=0))
        tw.write(obs.stage_profile_record({"phase_e": {
            "first_s": 1.0, "steady_s": 0.5, "compile_s": 0.5,
            "calls": 2}}))
        tw.write(_round(obs, 0, active=torch.tensor(3)))
        tw.write(_round(obs, 1, metrics={
            "train_loss": torch.tensor(0.5),
            "eff_lag_max": torch.tensor(2, dtype=torch.int32)},
            edges=torch.tensor([[0, 1], [2, 3]]),
            eval_point={"accuracy": 0.5, "train_loss": 0.5}))
        tw.write(obs.summary_record(rounds=2, wall_s=0.2, compile_s=1.0))
        assert tw.records == 5
    records, errors = obs.validate_trace(path)
    assert errors == []
    assert ref_obs.validate_trace(path) == (records, [])
    assert [r["type"] for r in records] == [
        "header", "stage_profile", "round", "round", "summary"]
    assert records[0]["schema"] == ref_obs.SCHEMA_VERSION == \
        obs.SCHEMA_VERSION
    assert records[3]["metrics"] == {"train_loss": 0.5, "eff_lag_max": 2}
    assert records[3]["edges"] == [[0, 1], [2, 3]]
    assert records[2]["active"] == 3
    assert obs.read_trace(path) == records


def _broken_records(mod):
    """Valid and broken records made with `mod`'s constructors."""
    recs = {"round": _round(mod),
            "header": mod.header_record(strategy="s", num_clients=1,
                                        num_rounds=1),
            "summary": mod.summary_record(rounds=1, wall_s=0.0,
                                          compile_s=0.0),
            "unknown": {"type": "nonsense"},
            "missing": {"type": "round", "round": 0}}
    r = _round(mod)
    del r["comm"]["energy_j"]
    recs["comm"] = r
    recs["score"] = _round(mod, score={"s_l": 1.0})
    recs["nonscalar"] = _round(mod, metrics={"arr": [1, 2]})
    recs["device_not_dict"] = _round(mod, device=[0.0])
    h = mod.header_record(strategy="s", num_clients=1, num_rounds=1)
    h["schema"] = 99
    recs["schema"] = h
    return recs


def test_validate_record_agrees_with_reference():
    got, want = _broken_records(obs), _broken_records(ref_obs)
    assert got == want
    for name, rec in got.items():
        assert obs.validate_record(rec) == ref_obs.validate_record(rec), name
        assert bool(obs.validate_record(rec)) == (
            name not in ("round", "header", "summary")), name


def test_writer_rejects_invalid_records(tmp_path):
    with obs.TraceWriter(str(tmp_path / "x.jsonl")) as tw:
        for rec in ({"type": "round", "round": 0}, {"type": "nonsense"}):
            with pytest.raises(ValueError):
                tw.write(rec)


def test_validate_trace_agrees_with_reference(tmp_path):
    """File-level checks (header first and alone, round indices strictly
    increasing, an empty file) on broken and valid files."""
    files = {
        "no_header": [_round(obs, 1), _round(obs, 0)],
        "two_headers": [obs.header_record(strategy="s", num_clients=1,
                                          num_rounds=1)] * 2,
        "repeat": [obs.header_record(strategy="s", num_clients=1,
                                     num_rounds=2), _round(obs, 0),
                   _round(obs, 0)],
        "valid": [obs.header_record(strategy="s", num_clients=1,
                                    num_rounds=2), _round(obs, 0),
                  _round(obs, 1)],
        "empty": [],
    }
    for name, recs in files.items():
        path = tmp_path / f"{name}.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in recs))
        got = obs.validate_trace(str(path))
        assert got == ref_obs.validate_trace(str(path)), name
        assert bool(got[1]) == (name != "valid"), name


def test_score_block_equals_reference():
    metrics = {"sel_s_l_mean": 1.0, "sel_s_d_mean": 0.1,
               "sel_s_p_mean": 0.9, "sel_cost_mean": 1.0,
               "mean_selected_score": 2.0}
    assert obs.score_block(metrics) == ref_obs.score_block(metrics) == {
        "s_l": 1.0, "s_d": 0.1, "s_p": 0.9, "cost": 1.0, "total": 2.0}
    del metrics["sel_cost_mean"]
    assert obs.score_block(metrics) is None


# ---------------------------------------------------------------------------
# timers
# ---------------------------------------------------------------------------

def test_stage_times_equal_reference():
    got, want = obs.StageTimes(), ref_obs.StageTimes()
    for t in (got, want):
        for label, dt in (("s", 1.0), ("s", 0.2), ("s", 0.4), ("once", 0.5)):
            t.add(label, dt)
    assert got.summary() == want.summary()
    s = got.summary()["s"]
    assert s["first_s"] == 1.0 and s["calls"] == 3
    assert s["steady_s"] == pytest.approx(0.3)
    with got.timed("slept"):
        time.sleep(0.01)
    assert got.first["slept"] >= 0.01


def test_instrument_stages_times_names_and_spans():
    """Each wrapped stage keeps its name, runs once per call, is timed,
    and shows as a `stage:<name>` span in a torch.profiler trace (the
    fence is a no-op on the CPU)."""
    def alpha(state, ctx):
        return state + 1

    def beta(state, ctx):
        ctx.metrics["x"] = torch.tensor(1.0)
        return state

    beta.stage_name = "custom_beta"
    times = obs.StageTimes()
    wrapped = obs.instrument_stages((alpha, beta), times)
    assert [obs.stage_name(s) for s in wrapped] == ["alpha", "custom_beta"]
    ctx = SimpleNamespace(metrics={}, aux={}, active=torch.ones(2, dtype=bool))
    state = torch.tensor(0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            for stage in wrapped:
                state = stage(state, ctx)
    assert int(state) == 2
    summary = times.summary()
    assert set(summary) == {"alpha", "custom_beta"}
    assert all(s["calls"] == 2 for s in summary.values())
    names = {e.key for e in prof.key_averages()}
    assert {"stage:alpha", "stage:custom_beta"} <= names


def test_round_clock_compile_steady_split():
    clock = obs.RoundClock()
    with clock.round():
        time.sleep(0.02)
    for _ in range(2):
        with clock.round():
            pass
    with clock.round():
        time.sleep(0.004)
    assert clock.rounds == 4
    assert clock.compile_s >= 0.02
    assert clock.elapsed() == clock.steady_s < clock.compile_s
    assert clock.last_s >= 0.004 and clock.last_s <= clock.steady_s


# ---------------------------------------------------------------------------
# the selection probe
# ---------------------------------------------------------------------------

def _probe_inputs(m=12, p=16, seed=0):
    rng = np.random.default_rng(seed)
    headers = rng.normal(size=(m, p)).astype(np.float32)
    last = np.where(rng.random((m, m)) < 0.5,
                    rng.integers(0, 4, size=(m, m)), -1).astype(np.int32)
    loss = rng.random((m, m)).astype(np.float32)
    return headers, last, loss


@pytest.mark.parametrize("cost", ["scalar", "matrix", "matrix_cand"])
def test_probe_matches_the_port_select_topk_and_reference(cost):
    """decompose_scores / probe_topk / check_fused_parity on the port's
    plain select_topk (its CPU route) and against the reference probe
    and the reference's blocked score_topk on the same inputs;
    components_of_selected recombines to the kernel's values and equals
    the always-on selected_components."""
    headers, last, loss = _probe_inputs()
    m = headers.shape[0]
    rng = np.random.default_rng(9)
    c = 0.3 if cost == "scalar" else \
        np.abs(rng.normal(size=(m, m))).astype(np.float32)
    cand = (rng.random((m, m)) < 0.7) if cost == "matrix_cand" else None
    t = 5
    kw = dict(alpha=1.0, lam=0.5)
    tc = c if cost == "scalar" else torch.from_numpy(c)
    tcand = None if cand is None else torch.from_numpy(cand)
    th, tl, tloss = (torch.from_numpy(a) for a in (headers, last, loss))
    vals, idx, _ = ops.select_topk(th, tl, tloss, t, tc, tcand, k=3, **kw)
    dec = obs.decompose_scores(th, tl, tloss, t, comm_cost=tc,
                               candidate_mask=tcand, **kw)
    obs.check_fused_parity(dec, vals, idx)
    rdec = ref_obs.decompose_scores(
        jnp.asarray(headers), jnp.asarray(last), jnp.asarray(loss),
        jnp.asarray(float(t)), comm_cost=jnp.asarray(c),
        candidate_mask=None if cand is None else jnp.asarray(cand), **kw)
    for name in ("s_l", "s_d", "s_p", "cost", "scores"):
        np.testing.assert_allclose(dec[name].numpy(), np.asarray(rdec[name]),
                                   atol=1e-5, rtol=0, err_msg=name)
    pv, pi = obs.probe_topk(dec, 3)
    rv, ri = ref_obs.probe_topk(rdec, 3)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), atol=1e-5)
    if cand is None:
        rvals, ridx, _ = ref_score_topk(
            jnp.asarray(headers), jnp.asarray(last), jnp.asarray(loss),
            jnp.asarray(float(t)), k=3, impl="blocked",
            comm_cost=jnp.asarray(c), **kw)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    comp = obs.components_of_selected(dec, idx, alpha=1.0)
    rcomp = ref_obs.components_of_selected(rdec, jnp.asarray(idx.numpy()),
                                           alpha=1.0)
    valid = vals > NEG / 2
    for name in ("s_l", "s_d", "s_p", "cost", "score"):
        np.testing.assert_allclose(comp[name].numpy(),
                                   np.asarray(rcomp[name]), atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(comp["score"][valid].numpy(),
                               vals[valid].numpy(), atol=1e-5)
    sel = selected_components(th, tl, tloss, t, idx, comm_cost=tc, **kw)
    for name in ("s_l", "s_d", "s_p", "cost"):
        np.testing.assert_allclose(comp[name].numpy(), sel[name].numpy(),
                                   atol=1e-5)
    bad = idx.clone()
    bad[0, 0] = (bad[0, 0] + 1) % m
    with pytest.raises(AssertionError):
        obs.check_fused_parity(dec, vals, bad)


def test_selection_graph_equals_reference(tmp_path):
    """The same masks (tensors on the port's side, numpy on the
    reference's) and edge arrays: counts, churn, edge list, frequency and
    record equal; the export reads back as the record."""
    rng = np.random.default_rng(2)
    m = 6
    g, rg = obs.SelectionGraph(m), ref_obs.SelectionGraph(m)
    for r in range(4):
        mask = rng.random((m, m)) < 0.3
        g.observe(torch.from_numpy(mask))
        rg.observe(mask)
    g.observe(np.asarray([[0, 1], [1, 2]]))
    rg.observe(np.asarray([[0, 1], [1, 2]]))
    assert g.churn == rg.churn and g.rounds == rg.rounds == 5
    np.testing.assert_array_equal(g.counts, rg.counts)
    np.testing.assert_array_equal(g.frequency(), rg.frequency())
    assert g.to_record() == rg.to_record()
    assert obs.validate_record(g.to_record()) == []
    out = tmp_path / "graph.json"
    g.export_json(str(out))
    assert json.loads(out.read_text()) == g.to_record()


# ---------------------------------------------------------------------------
# run_experiment(trace=...)
# ---------------------------------------------------------------------------

M = 6
FL_KW = dict(num_clients=M, peers_per_round=2, batch_size=8,
             client_sample_ratio=0.5, epochs_extractor=1, epochs_header=1,
             probe_size=4, use_score_kernel=True)


@pytest.fixture(scope="module")
def sim_setup():
    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=8)
    data = client_datasets_cifar(0, M, samples_per_class=10, image_size=8)
    fl = FLConfig(device_profile=DeviceProfile(
        family="bimodal", straggler_fraction=0.5, straggler_slowdown=4.0),
        deadline_s=1.0, comms=CommsConfig(
            topology="ring", ring_hops=2, p_stale=0.3, stale_mode="serve"),
        **FL_KW)
    return cfg, data, fl


def _run(cfg, fl, data, name, **kw):
    return simulator.run_experiment(
        name, cfg, fl, data, num_rounds=3, eval_every=2, steps_per_epoch=1,
        verbose=False, device="cpu", **kw)


HOST_TIME = ("wall_s", "compile_s")


@pytest.mark.parametrize("name", ["pfeddst_async", "dfedavgm"])
def test_traced_run_valid_for_reference_and_equal_to_history(
        sim_setup, tmp_path, name):
    """A pfeddst_async run (bimodal profile, 1 s deadline, a ring with
    stale serving, the stage profile and edges on) and a dfedavgm run:
    the trace passes the port's and the reference's `validate_trace` and
    `tools/trace_report.py --validate`; each round record equals the
    History's round columns and extra scalars, the eval records its eval
    points; the selection graph counts the rounds' edges; and the
    History equals an untraced run's (the stage profile runs on
    throwaway state) up to the host walls."""
    cfg, data, fl = sim_setup
    if name == "dfedavgm":
        fl = dataclasses.replace(fl, device_profile=None,
                                 deadline_s=float("inf"),
                                 comms=CommsConfig(topology="ring"), lr=0.01)
    path = str(tmp_path / "t.jsonl")
    masks, actives = [], []

    def on_round(r, met):
        masks.append(met.get("select_mask", met.get("comm_edges")).clone())
        actives.append(int(met["active"].sum()))

    traced = _run(cfg, fl, data, name, trace=path,
                  trace_stages=name == "pfeddst_async", trace_edges=True,
                  on_round=on_round)
    plain = _run(cfg, fl, data, name)
    records, errors = obs.validate_trace(path)
    assert errors == []
    assert ref_obs.validate_trace(path) == (records, [])
    assert _trace_report().main([path, "--validate"]) == 0
    by = {}
    for rec in records:
        by.setdefault(rec["type"], []).append(rec)
    assert records[0]["type"] == "header" and records[-1]["type"] == \
        "summary"
    assert by["header"][0]["strategy"] == name
    h = traced.to_dict()
    for r, rec in enumerate(by["round"]):
        assert rec["round"] == r and rec["compile"] == (r == 0)
        assert rec["comm"] == {"bytes": h["round_bytes"][r],
                               "net_time_s": h["round_net_time_s"][r],
                               "energy_j": rec["comm"]["energy_j"]}
        assert rec["device"] == {"wall_s": h["round_device_wall_s"][r],
                                 "straggler_s":
                                 h["round_straggler_wall_s"][r],
                                 "eff_lag": h["round_eff_lag"][r]}
        assert rec["stale_mean"] == h["round_stale_lag"][r]
        assert rec["stale_max"] == h["round_stale_max"][r]
        assert rec["metrics"] == {k: v[r] for k, v in h["extra"].items()}
        assert rec["edges"] == sorted(map(list, zip(*np.nonzero(
            masks[r].numpy()))))
        assert rec["active"] == actives[r]
    evals = [rec["eval"] for rec in by["round"] if "eval" in rec]
    assert [e["accuracy"] for e in evals] == h["accuracy"]
    graph = by["selection_graph"][0]
    assert graph["rounds"] == 3
    assert sum(e[2] for e in graph["edges"]) == sum(
        int(mk.sum()) for mk in masks)
    if name == "pfeddst_async":
        assert "score" in by["round"][0]
        stages = by["stage_profile"][0]["stages"]
        assert list(stages) == ["deadline_gate", "score_select",
                                "aggregate", "phase_e", "phase_h",
                                "publish", "update_context"]
        assert all(s["calls"] == 2 for s in stages.values())
        assert h["extra"]["round_wall_s"] == h["round_device_wall_s"]
    else:
        assert "score" not in by["round"][0]
        assert "stage_profile" not in by
    p = plain.to_dict()
    for key in set(h) - set(HOST_TIME):
        assert h[key] == p[key], key
