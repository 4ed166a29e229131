"""The engine's strategy API and the chunked driver of the port:
`StrategySpec` / `make_spec` / `make_round` / `make_multi_round` and
`run_experiment(chunk_rounds=)`, mirroring the reference's scan-over-rounds
tests (tests/test_engine.py) at its tiny CNN sizes; and, against the JAX
reference, `History.rounds_to_target` / `bytes_to_target`, the timers'
attribution, the packages' public exports and the Eq. 6 matrix they
export.

A chunk runs the very rounds `make_round` runs, so chunk parity is
bitwise: state and every metric. Against the reference: the
loss-disparity forward passes rtol 1e-4 (a few f32 ulps per layer between XLA's and torch's CPU
convolutions, as in tests/test_torch_model.py).
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.fl as ref_fl
from repro import obs as ref_obs
from repro.configs import get_config as ref_get_config
from repro.configs.base import FLConfig as RefFLConfig
from repro.core import scoring as ref_scoring
from repro.fl.simulator import History as RefHistory
from repro.models import model as ref_model
from repro.obs.timers import RoundClock as RefRoundClock
import repro_torch.core as core
import repro_torch.fl as fl_pkg
from repro_torch import convert, obs
from repro_torch.configs import CommsConfig, FLConfig, get_config
from repro_torch.data.synthetic import client_datasets_cifar
from repro_torch.fl import engine, simulator, strategies
from repro_torch.fl.engine import (
    StrategySpec,
    chain_rounds,
    make_multi_round,
    make_round,
)
from repro_torch.utils import pytree

from test_torch_support import to_numpy, to_torch

M = 6
RING = CommsConfig(topology="ring", availability=0.9, p_link_drop=0.1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: as fast for these tiny tensors, and parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env():
    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=8)
    data = client_datasets_cifar(0, M, samples_per_class=10, image_size=8)
    train = {"images": data["train_x"], "labels": data["train_y"]}
    return cfg, data, train


FL_KW = dict(num_clients=M, peers_per_round=2, batch_size=8,
             client_sample_ratio=0.5, epochs_extractor=1, epochs_header=1,
             probe_size=4)


def _fl(comms=None):
    return FLConfig(**FL_KW, **({"comms": comms} if comms is not None
                                else {}))


def _assert_bitwise(a, b, what):
    la, lb = pytree.tree_paths(a), pytree.tree_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, (what, path)
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{what}: {path}")
        else:
            assert x == y, (what, path)


def _sequential(strat, train, rounds, seed=3, start=0):
    state, mets = strat.init(1), []
    for r in range(start, start + rounds):
        state, met = strat.round(state, train, (seed, r))
        mets.append(met)
    return state, mets


def _chunked(strat, fl, train, rounds, chunk, seed=3):
    fn = make_multi_round(strat.spec, fl, strat.fabric, chunk_rounds=chunk)
    state, stacks = strat.init(1), []
    for r0 in range(0, rounds, chunk):
        state, stacked = fn(state, train, seed, r0)
        stacks.append(stacked)
    return state, stacks


# ---------------------------------------------------------------------------
# the spec API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", strategies.STRATEGIES)
def test_make_spec_matches_reference_spec(env, name):
    """Every registered strategy has a StrategySpec whose metadata, stream
    layout and stage names are the reference's."""
    from repro.obs.timers import stage_name as ref_stage_name

    spec = strategies.make_spec(name, env[0], _fl(), 1, device="cpu")
    ref = ref_fl.make_spec(name, ref_get_config("resnet18-cifar").reduced(),
                           RefFLConfig(**FL_KW), 1)
    assert isinstance(spec, StrategySpec)
    for field in ("name", "key_streams", "sample_stream", "comm_pattern",
                  "payload_kind", "payload_fraction", "needs_head_finetune",
                  "versioned"):
        assert getattr(spec, field) == getattr(ref, field), field
    assert (spec.affinity is None) == (ref.affinity is None)
    assert [obs.stage_name(s) for s in spec.stages] == \
        [ref_stage_name(s) for s in ref.stages]
    assert spec.sample_stream in spec.key_streams


def test_make_strategy_is_make_spec_and_make_round(env):
    """make_strategy keeps every field it had and carries its spec; its
    round is make_round's, bit for bit."""
    cfg, _, train = env
    fl = _fl()
    strat = strategies.make_strategy("dfedavgm", cfg, fl, 1, device="cpu")
    spec = strat.spec
    assert (strat.stages, strat.key_streams, strat.init) == \
        (spec.stages, spec.key_streams, spec.init)
    round_fn = make_round(spec, fl, strat.fabric)
    a, ma = strat.round(strat.init(1), train, (3, 0))
    b, mb = round_fn(spec.init(1), train, (3, 0))
    _assert_bitwise(a, b, "state")
    _assert_bitwise(ma, mb, "metrics")


def test_make_round_refuses_the_reference_compile_options(env):
    """jit= and client_axis= have no counterpart in the eager port: they
    are refused, not ignored."""
    spec = strategies.make_spec("fedavg", env[0], _fl(), 1, device="cpu")
    with pytest.raises(TypeError):
        make_round(spec, _fl(), jit=False)
    with pytest.raises(TypeError):
        make_multi_round(spec, _fl(), chunk_rounds=2, client_axis="data")


def test_run_round_samples_from_the_spec_stream():
    """run_round draws the participants from `sample_stream`, keeping the
    ids on the host too (ctx.sampled_host), equal to the device copy."""
    seen = {}

    def probe(state, ctx):
        seen["idx"], seen["host"] = ctx.sampled_idx, ctx.sampled_host
        return state

    data = {"x": torch.zeros(8, 1)}
    want = engine.sample_participants(
        engine.named_streams((0, 1), ("a", "b"))["b"], 8, 0.5)[0]
    engine.run_round((probe,), None, data, (0, 1), m=8, ratio=0.5,
                     key_streams=("a", "b"), sample_stream="b")
    assert torch.equal(seen["idx"], want)
    assert torch.equal(seen["host"], want)
    assert seen["host"].device.type == "cpu"


# ---------------------------------------------------------------------------
# chunk parity (tests/test_engine.py's scan-over-rounds tests)
# ---------------------------------------------------------------------------

def test_multi_round_chunk1_matches_single_round(env):
    cfg, _, train = env
    fl = _fl()
    strat = strategies.make_strategy("pfeddst", cfg, fl, 1, device="cpu")
    ref_state, ref_mets = _sequential(strat, train, 1)
    got_state, (stacked,) = _chunked(strat, fl, train, 1, 1)
    _assert_bitwise(got_state, ref_state, "state (R=1)")
    _assert_bitwise(engine.unstack_metrics(stacked, 1)[0], ref_mets[0],
                    "metrics (R=1)")


@pytest.mark.parametrize("name,comms", [
    ("pfeddst", None), ("dispfl", None), ("pfeddst_async", None),
    ("pfeddst", RING), ("dfedavgm", RING)],
    ids=["pfeddst", "dispfl", "pfeddst_async", "pfeddst-ring",
         "dfedavgm-ring"])
def test_multi_round_chunk_matches_sequential(env, name, comms):
    """A 4-round chunk equals 4 sequential make_round calls bitwise, state
    and every stacked per-round metric (pfeddst_async: the peer store is
    written in place by back-to-back rounds with no fence)."""
    cfg, _, train = env
    fl = _fl(comms)
    strat = strategies.make_strategy(name, cfg, fl, 1, device="cpu")
    ref_state, ref_mets = _sequential(strat, train, 4)
    got_state, (stacked,) = _chunked(strat, fl, train, 4, 4)
    _assert_bitwise(got_state, ref_state, f"{name}: state")
    for k, v in stacked.items():
        assert isinstance(v, torch.Tensor) and v.shape[0] == 4, k
    for i, met in enumerate(engine.unstack_metrics(stacked, 4)):
        _assert_bitwise(met, ref_mets[i], f"{name}: metrics[{i}]")


def test_multi_round_resumes_across_chunks(env):
    """Two chunks of 2 (start 0, then 2) equal one chunk of 4 and four
    sequential rounds: `start` keys the rounds as the flat schedule."""
    cfg, _, train = env
    fl = _fl()
    strat = strategies.make_strategy("pfeddst", cfg, fl, 1, device="cpu")
    ref_state, _ = _sequential(strat, train, 4)
    two_state, stacks = _chunked(strat, fl, train, 4, 2)
    four_state, (four,) = _chunked(strat, fl, train, 4, 4)
    assert len(stacks) == 2
    _assert_bitwise(two_state, ref_state, "state (2x R=2)")
    _assert_bitwise(two_state, four_state, "state (2x R=2 vs R=4)")
    for k, v in four.items():
        torch.testing.assert_close(torch.cat([s[k] for s in stacks]), v,
                                   rtol=0, atol=0, equal_nan=True, msg=k)


def test_chunk_stacks_tensors_and_lists_host_values():
    """Tensor metrics stack on their device into (R, ...) (a round that
    writes a tensor in place after reporting it does not reach the stack);
    host values stay lists; metrics_to_host keeps every value."""
    buf = torch.zeros(2)

    def stage(state, ctx):
        buf.add_(1.0)
        ctx.record("live", buf)
        ctx.record("host", float(buf[0]))
        ctx.record("mask", torch.eye(2, dtype=torch.bool))
        return state + 1

    spec = StrategySpec(name="toy", init=lambda seed: torch.tensor(0),
                        stages=(stage,), params_for_eval=lambda s: s,
                        key_streams=("act",))
    fl = FLConfig(num_clients=2, client_sample_ratio=0.5)
    fn = make_multi_round(spec, fl, chunk_rounds=3)
    state, stacked = fn(spec.init(0), {"x": torch.zeros(2, 1)}, 0, 5)
    assert int(state) == 3
    assert stacked["live"].tolist() == [[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]]
    assert stacked["host"] == [1.0, 2.0, 3.0]
    assert stacked["mask"].shape == (3, 2, 2)
    assert stacked["active"].dtype == torch.bool
    host = engine.metrics_to_host(stacked)
    for k, v in stacked.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(host[k], v), k
        else:
            assert host[k] == v, k


def test_chunk_refuses_rounds_with_different_metrics():
    def stage(state, ctx):
        if int(state) == 1:
            ctx.record("late", torch.tensor(1.0))
        return state + 1

    spec = StrategySpec(name="toy", init=lambda seed: torch.tensor(0),
                        stages=(stage,), params_for_eval=lambda s: s,
                        key_streams=("act",))
    fn = make_multi_round(spec, FLConfig(num_clients=2), chunk_rounds=2)
    with pytest.raises(ValueError, match="late"):
        fn(spec.init(0), {"x": torch.zeros(2, 1)}, 0, 0)


# ---------------------------------------------------------------------------
# the chunked driver
# ---------------------------------------------------------------------------

def _walls_aside(rec):
    return {k: v for k, v in rec.items()
            if k not in ("wall_s", "compile", "compile_s")}


def test_chunked_run_trace_and_history_equal_per_round_run(env, tmp_path):
    """run_experiment(chunk_rounds=4, eval_every=2): a trace the port's
    and the reference's validators accept, per-round records 0..3 with
    compile flags [T, T, F, F] (eval_every caps the first chunk at 2
    rounds) and eval points at rounds 1 and 3; the History, walls aside,
    and every trace record, walls and compile flags aside, equal the
    chunk_rounds=1 run's. on_round sees each unstacked round."""
    cfg, data, _ = env
    fl = _fl()
    runs, seen = {}, {}
    for chunk in (4, 1):
        path = str(tmp_path / f"c{chunk}.jsonl")
        seen[chunk] = []
        hist = simulator.run_experiment(
            "pfeddst", cfg, fl, data, num_rounds=4, eval_every=2,
            steps_per_epoch=1, seed=0, verbose=False, device="cpu",
            trace=path, trace_edges=True, chunk_rounds=chunk,
            on_round=lambda r, met, c=chunk: seen[c].append(
                (r, met["select_mask"].clone())))
        records, errors = obs.validate_trace(path)
        assert errors == []
        assert ref_obs.validate_trace(path) == (records, [])
        runs[chunk] = (hist, records)
    hist, records = runs[4]
    rounds = [r for r in records if r["type"] == "round"]
    assert [r["round"] for r in rounds] == [0, 1, 2, 3]
    assert [r["compile"] for r in rounds] == [True, True, False, False]
    assert [("eval" in r) for r in rounds] == [False, True, False, True]
    assert hist.compile_s > 0 and hist.rounds == [2, 4]
    h, p = hist.to_dict(), runs[1][0].to_dict()
    for key in set(h) - {"wall_s", "compile_s"}:
        assert h[key] == p[key], key
    assert len(records) == len(runs[1][1])
    for a, b in zip(records, runs[1][1]):
        assert _walls_aside(a) == _walls_aside(b)
    assert [r for r, _ in seen[4]] == [0, 1, 2, 3]
    for (_, a), (_, b) in zip(seen[4], seen[1]):
        assert torch.equal(a, b)


def test_chunk_schedule_ends_at_eval_boundaries(env, monkeypatch):
    """Chunks end at every eval point and one chunk function is built per
    distinct size: 7 rounds, eval_every 3, chunk_rounds 2 → sizes
    2, 1, 2, 1, 1; functions for sizes 2 and 1."""
    cfg, data, _ = env
    built, sizes = [], []
    real = simulator.chain_rounds

    def spy(round_fn, chunk_rounds):
        built.append(chunk_rounds)
        fn = real(round_fn, chunk_rounds)

        def run(state, data, seed, start):
            sizes.append((start, chunk_rounds))
            return fn(state, data, seed, start)

        return run

    monkeypatch.setattr(simulator, "chain_rounds", spy)
    hist = simulator.run_experiment(
        "fedavg", cfg, _fl(), data, num_rounds=7, eval_every=3,
        steps_per_epoch=1, verbose=False, device="cpu", chunk_rounds=2)
    assert sizes == [(0, 2), (2, 1), (3, 2), (5, 1), (6, 1)]
    assert built == [2, 1]
    assert hist.rounds == [3, 6, 7]


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_both_loops_run_the_strategys_round_function(env, monkeypatch,
                                                     chunk):
    """The per-round and the chunked loop call the same `Strategy.round`:
    a caller's own round function (here one that injects draws) runs on
    either, keyed (seed, r) for r = 0..3."""
    cfg, data, _ = env
    keys = []
    real = simulator.make_strategy

    def make(*args, **kw):
        strat = real(*args, **kw)
        inner = strat.round

        def round_fn(state, d, key, draws=None):
            keys.append(tuple(key))
            return inner(state, d, key, {"act": np.array([0, 2, 4])})

        strat.round = round_fn
        return strat

    monkeypatch.setattr(simulator, "make_strategy", make)
    seen = []
    simulator.run_experiment(
        "fedavg", cfg, _fl(), data, num_rounds=4, eval_every=4,
        steps_per_epoch=1, seed=7, verbose=False, device="cpu",
        chunk_rounds=chunk,
        on_round=lambda r, met: seen.append(met["active"].tolist()))
    assert keys == [(7, r) for r in range(4)]
    assert seen == [[True, False, True, False, True, False]] * 4


@pytest.mark.parametrize("start", [0, 5])
def test_chain_rounds_keys_and_stacks_a_round_function(start):
    """chain_rounds calls the round function once per round, keyed
    (seed, start + i) with no draws, and stacks what it returns."""
    calls = []

    def round_fn(state, data, key, draws=None):
        calls.append((tuple(key), draws))
        return state + 1, {"r": torch.tensor(key[1]), "k": key}

    state, stacked = chain_rounds(round_fn, 3)(torch.tensor(0), {}, 9, start)
    assert int(state) == 3
    assert calls == [((9, start + i), None) for i in range(3)]
    assert stacked["r"].tolist() == [start, start + 1, start + 2]
    assert stacked["k"] == [(9, start + i) for i in range(3)]


# ---------------------------------------------------------------------------
# History, timers, exports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", [0.1, 0.3, 0.45, 0.5, 0.9])
def test_history_targets_equal_reference(target):
    kw = dict(rounds=[5, 10, 15, 20], accuracy=[0.2, 0.45, 0.4, 0.5],
              comm_bytes=[100, 250, 400, 560])
    got, want = simulator.History(**kw), RefHistory(**kw)
    assert got.rounds_to_target(target) == want.rounds_to_target(target)
    assert got.bytes_to_target(target) == want.bytes_to_target(target)


def test_stage_times_attribution_equals_reference():
    """The same fed call walls: the first is the label's first-call entry,
    the rest its steady list, and the summaries agree."""
    got, want = obs.StageTimes(), ref_obs.StageTimes()
    feed = (("s", 2.0), ("s", 0.8), ("s", 0.3), ("once", 0.5), ("s", 0.9))
    for t in (got, want):
        for label, dt in feed:
            t.add(label, dt)
    assert got.first == want.first and got.steady == want.steady
    assert got.summary() == want.summary()
    assert got.summary()["s"]["calls"] == 4
    with got.timed("slept"):
        time.sleep(0.005)
    assert got.first["slept"] >= 0.005


def test_round_clock_chunk_attribution_equals_reference(monkeypatch):
    """The same fed durations through chunk(n) and round(): the first
    chunk's whole wall is compile_s, later chunks add to steady_s,
    last_s is wall / n."""
    def run(clock):
        ticks = iter([0.0, 3.0, 10.0, 12.0, 20.0, 20.5, 30.0, 33.0])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        out = []
        for ctx in (clock.chunk(3), clock.chunk(4), clock.round(),
                    clock.chunk(2)):
            with ctx:
                pass
            out.append(clock.last_s)
        monkeypatch.undo()
        return out, (clock.compile_s, clock.steady_s, clock.rounds,
                     clock.elapsed())

    got, want = run(obs.RoundClock()), run(RefRoundClock())
    assert got == want
    assert got[0] == [1.0, 0.5, 0.5, 1.5]
    assert got[1] == (3.0, 5.5, 10, 5.5)


def test_public_exports_cover_the_reference():
    for name in ref_fl.__all__:
        assert hasattr(fl_pkg, name), name
    assert set(fl_pkg.__all__) == set(ref_fl.__all__)
    for name in ref_core.__all__ + ["make_pfeddst_stages",
                                    "PFEDDST_STREAMS"]:
        assert hasattr(core, name), name
    assert set(core.__all__) == set(ref_core.__all__)
    assert core.PFEDDST_STREAMS == ref_core.PFEDDST_STREAMS
    assert fl_pkg.run_experiment is simulator.run_experiment
    with pytest.raises(AttributeError):
        fl_pkg.not_a_name


# ---------------------------------------------------------------------------
# the Eq. 6 export, against the reference
# ---------------------------------------------------------------------------

def _cnn_pair():
    ref_cfg = dataclasses.replace(ref_get_config("resnet18-cifar").reduced(),
                                  dtype="float32", image_size=8)
    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=8)
    return ref_cfg, cfg


def test_loss_disparity_matrix_export_matches_reference():
    """The exported Eq. 6 matrix (the rows form over every client) against
    the reference's; rtol 1e-4 (CNN forward passes, as in
    tests/test_torch_model.py)."""
    ref_cfg, cfg = _cnn_pair()
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    # jitted: the eager vmaps trace op by op (seconds each)
    rp = jax.jit(jax.vmap(lambda k: ref_model.init_params(ref_cfg, k)))(keys)
    rng = np.random.default_rng(7)
    probe = {"images": rng.normal(size=(3, 4, 8, 8, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, size=(3, 4)).astype(np.int32)}
    jprobe = jax.tree_util.tree_map(jnp.asarray, probe)
    tprobe = {k: to_torch(v) for k, v in probe.items()}
    params = convert.params_from_reference(to_numpy(rp), device="cpu")
    want = jax.jit(lambda p, b: ref_core.loss_disparity_matrix(
        ref_cfg, p, b))(rp, jprobe)
    got = core.loss_disparity_matrix(cfg, params, tprobe)
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
