"""The port's experiment drivers against the reference's: the surface of
`repro_torch.examples.fl_cifar_sim` (every flag of `examples/fl_cifar_sim.py`
with the same default, type and choices, plus `--device`) and the
configurations both drivers build from the same argv; the quickstart's
configuration likewise; and one CPU run of each driver end to end.

Both drivers are loaded as modules and their `run_experiment` and dataset
function replaced in each module's own namespace by recorders, so a run
builds its configs and stops there. Nothing of the JAX package changes.
"""
import ast
import dataclasses
import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.fl.simulator import History as RefHistory
from repro_torch.examples import fl_cifar_sim, quickstart
from repro_torch.fl.simulator import History
from repro_torch.kernels.build import BUILD_DIR

ROOT = Path(__file__).resolve().parent.parent
REF_SIM = ROOT / "examples" / "fl_cifar_sim.py"
REF_QUICK = ROOT / "examples" / "quickstart.py"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: as fast for these tiny tensors, and parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARGVS = {
    "default": [],
    "paper-scale": ["--paper-scale"],
    "ring-hetero": ["--topology", "ring", "--link-model", "hetero"],
    "async": ["--strategies", "pfeddst", "pfeddst_async",
              "--device-profile", "bimodal", "--straggler-fraction", "0.5",
              "--deadline", "1.2", "--staleness-alpha", "0.5"],
    "open-world": ["--strategies", "pfeddst", "dfedavgm",
                   "--adversary-fraction", "0.25", "--attack", "sign_flip",
                   "--defense", "trimmed_mean", "--churn-join", "0.05",
                   "--churn-leave", "0.05"],
    "traced": ["--strategies", "fedavg", "dispfl", "--trace-out",
               "t.jsonl", "--trace-stages", "--rounds", "7", "--seed", "3",
               "--init-alive", "0.5"],
}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_sim():
    return _load(REF_SIM, "ref_fl_cifar_sim")


class _Recorder:
    """Stands in for a driver's run_experiment and dataset function."""

    def __init__(self, history_cls):
        self.runs, self.data = [], []
        self.history_cls = history_cls

    def make_data(self, *args, **kw):
        self.data.append((args[1:], kw))
        return {"train_x": None}

    def run_experiment(self, name, cfg, fl, data, **kw):
        self.runs.append((name, cfg, fl, kw))
        return self.history_cls(accuracy=[0.5], comm_bytes=[1],
                                net_time_s=[0.0], device_time_s=[0.0])


def _record(monkeypatch, mod, history_cls):
    rec = _Recorder(history_cls)
    monkeypatch.setattr(mod, "run_experiment", rec.run_experiment)
    monkeypatch.setattr(mod, "client_datasets_cifar", rec.make_data)
    return rec


def _same_config(got, want, what):
    """Every field of the port's dataclass equals the reference's; a
    field only the reference has is at its default."""
    names = {f.name for f in dataclasses.fields(got)}
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        if f.name not in names:
            default = f.default if f.default_factory is dataclasses.MISSING \
                else f.default_factory()
            assert w == default, (what, f.name)
            continue
        g = getattr(got, f.name)
        if dataclasses.is_dataclass(w):
            assert dataclasses.is_dataclass(g), (what, f.name)
            _same_config(g, w, f"{what}.{f.name}")
        else:
            assert g == w, (what, f.name, g, w)


@pytest.mark.parametrize("case", list(ARGVS))
def test_driver_builds_the_reference_configs(ref_sim, monkeypatch, case):
    argv = ARGVS[case]
    ref = _record(monkeypatch, ref_sim, RefHistory)
    monkeypatch.setattr(sys, "argv", ["fl_cifar_sim.py", *argv])
    ref_sim.main()
    port = _record(monkeypatch, fl_cifar_sim, History)
    fl_cifar_sim.main([*argv, "--device", "cpu"])
    assert [r[0] for r in port.runs] == [r[0] for r in ref.runs]
    assert port.data == ref.data
    if case == "open-world":
        assert ref.runs[0][3]["eval_mask"] is not None
    for (_, cfg, fl, kw), (_, rcfg, rfl, rkw) in zip(port.runs, ref.runs):
        for field in ("name", "family", "dtype", "cnn_stages", "cnn_width",
                      "image_size", "image_channels", "num_classes"):
            assert getattr(cfg, field) == getattr(rcfg, field), field
        _same_config(fl, rfl, "FLConfig")
        assert kw.pop("device") == "cpu"
        mask, rmask = kw.pop("eval_mask"), rkw.pop("eval_mask")
        assert (mask is None) == (rmask is None)
        if mask is not None:
            np.testing.assert_array_equal(mask, np.asarray(rmask))
        assert kw == rkw
    if case == "traced":
        assert port.runs[0][3]["chunk_rounds"] == 1
        assert port.runs[0][3]["trace"] == "t.fedavg.jsonl"


def _reference_flags(ref_mod) -> dict:
    """{flag: {keyword: value}} of every add_argument call in the
    reference driver, read from its source (values evaluated in the
    module's namespace, e.g. `list(TOPOLOGIES)`)."""
    flags = {}
    for node in ast.walk(ast.parse(REF_SIM.read_text())):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "add_argument":
            flag = ast.literal_eval(node.args[0])
            flags[flag] = {kw.arg: eval(ast.unparse(kw.value),
                                        vars(ref_mod))
                           for kw in node.keywords if kw.arg != "help"}
    return flags


def test_driver_flags_equal_the_reference_flags(ref_sim):
    want = _reference_flags(ref_sim)
    actions = {a.option_strings[0]: a
               for a in fl_cifar_sim.build_parser()._actions
               if a.option_strings and a.option_strings[0] != "-h"}
    assert set(actions) - set(want) == {"--device"}
    assert set(want) <= set(actions)
    assert actions["--device"].default == "cuda"
    for flag, kw in want.items():
        act = actions[flag]
        if kw.get("action") == "store_true":
            assert act.const is True and act.default is False, flag
            continue
        assert act.default == kw.get("default"), flag
        assert act.type == kw.get("type"), flag
        assert act.choices == kw.get("choices"), flag
        assert act.nargs == kw.get("nargs"), flag
        assert act.const == kw.get("const"), flag
        assert act.metavar == kw.get("metavar"), flag


class _Stop(Exception):
    pass


def test_quickstart_builds_the_reference_config(monkeypatch):
    """Both quickstarts, their dataset function, population init and round
    replaced by recorders: the same data sizes, population size, model
    and FLConfig reach the round."""
    def recorders():
        seen = {}

        def data(*args, **kw):
            seen["data"] = (args[1:], kw)
            return {k: torch.zeros(1) for k in
                    ("train_x", "train_y", "test_x", "test_y")}

        def init(cfg, gen, m, *args):
            seen["init"] = (cfg, m)

        def round_(cfg, fl, steps, state, train, key, **kw):
            seen["round"] = (cfg, fl, kw)
            raise _Stop

        return seen, data, init, round_

    ref = _load(REF_QUICK, "ref_quickstart")
    rseen, data, init, round_ = recorders()
    for name, fn in (("client_datasets_cifar", data),
                     ("init_population", init), ("pfeddst_round", round_),
                     ("make_phase_steps", lambda *a: None)):
        monkeypatch.setattr(ref, name, fn)
    monkeypatch.setattr(ref, "jax", SimpleNamespace(
        random=jax.random, jit=lambda f: f))
    with pytest.raises(_Stop):
        ref.main()
    seen, data, init, round_ = recorders()
    for name, fn in (("client_datasets_cifar", data),
                     ("init_population", init), ("pfeddst_round", round_)):
        monkeypatch.setattr(quickstart, name, fn)
    with pytest.raises(_Stop):
        quickstart.main(["--device", "cpu"])
    assert seen["data"] == rseen["data"]
    assert seen["init"][1] == rseen["init"][1]
    cfg, fl, kw = seen["round"]
    rcfg, rfl, rkw = rseen["round"]
    assert kw == rkw
    for field in ("name", "family", "cnn_stages", "cnn_width", "dtype"):
        assert getattr(cfg, field) == getattr(rcfg, field), field
    _same_config(fl, rfl, "FLConfig")
    assert quickstart.build_config()[1] == fl


@pytest.mark.parametrize("main", [
    lambda: fl_cifar_sim.main(["--rounds", "1"]),
    lambda: quickstart.main([])], ids=["fl_cifar_sim", "quickstart"])
def test_drivers_default_to_cuda(monkeypatch, main):
    """Without --device the drivers ask for CUDA and raise where there is
    none, before building any data."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main()


def test_driver_runs_end_to_end_on_the_cpu(capsys, tmp_path):
    """The CLI once, on the CPU: 2 rounds of dfedpgp on the reduced
    default (one chunk of 2 under the default --chunk-rounds 5), a trace,
    the reference's final table; --compile-cache prints the kernels'
    build directory."""
    trace = str(tmp_path / "run.jsonl")
    hists = fl_cifar_sim.main(["--device", "cpu", "--rounds", "2",
                               "--strategies", "dfedpgp", "--trace-out",
                               trace, "--compile-cache"])
    out = capsys.readouterr().out
    hist = hists["dfedpgp"]
    assert hist.rounds == [2] and np.isfinite(hist.accuracy).all()
    assert hist.comm_bytes[-1] > 0
    assert str(BUILD_DIR) in out
    assert "final personalized accuracy (full topology, uniform links):" \
        in out
    assert f"dfedpgp          acc={hist.accuracy[-1]:.4f}" in out
    from repro_torch.obs import validate_trace

    records, errors = validate_trace(trace)
    assert errors == []
    rounds = [r for r in records if r["type"] == "round"]
    assert [r["compile"] for r in rounds] == [True, True]


def test_quickstart_runs_end_to_end_on_the_cpu(capsys):
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert text.count("selections per active client") == 3
    assert "personalized accuracy: mean=" in text
    assert 0.0 <= out["accuracy"] <= 1.0
    mask = out["metrics"]["select_mask"]
    assert mask.shape == (6, 6) and not mask.diagonal().any()
