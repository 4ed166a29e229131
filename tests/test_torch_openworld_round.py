"""Open-world rounds of the port against live rounds of the JAX reference:
the reference's wrapped spec (`repro.fl.strategies.make_spec`, through
`repro.openworld.make_open_spec`) run by its engine, the port's
`make_strategy` with the reference's draws injected (`draws=`, plus
`draws["churn"]` = the reference's leave/join uniforms and
`draws["byz"]` = its gaussian noise, both derived from the reference's
salted "act" stream), the state carried across by each package on its
own.

M = 6, k = 2, ratio 0.5, the reduced ResNet in f32 at width 32 (see
tests/test_torch_round.py for why not 16), 2 rounds a scenario (3 under
churn):
pfeddst under sign_flip + score_game="both" with each defense (the fused
select_topk route, fed the spoofed headers and the (M, M) cost), fedavg
with each star reducer, dfedavgm with the robust mixer; the churn
scenarios, by the same runner, are in tests/test_torch_openworld_churn.py.
`active`, `alive`, `select_mask` / `comm_edges`
must match exactly (dispfl's masks as in tests/test_torch_baselines.py:
flips only next to a threshold, at most 8); parameters, optimizer
momenta, loss matrices and the scalar metrics at rtol 2e-3 with an
absolute floor of 2e-3 × the leaf's largest entry. Exact selection rests
on well-separated scores; the pfeddst scenarios check the margin on the
spoofed headers.

Port-only: the zero-rate churn and noise_std=0 wraps equal the closed
port run bit for bit; `run_experiment(eval_mask=)`; the trace's
`adversaries` key, validated by `repro.obs.trace`.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import ChurnConfig as RefChurnConfig
from repro.configs.base import FLConfig as RefFLConfig
from repro.configs.base import ThreatConfig as RefThreatConfig
from repro.fl.engine import named_streams as ref_named_streams
from repro.fl.engine import run_round as ref_run_round
from repro.fl.strategies import make_spec as ref_make_spec
from repro.obs.trace import validate_trace as ref_validate_trace
from repro.openworld import attacks as ref_attacks
from repro.openworld import lifecycle as ref_lifecycle
from repro_torch import convert
from repro_torch.configs import (ChurnConfig, FLConfig, ThreatConfig,
                                 get_config)
from repro_torch.core.scoring import flatten_headers
from repro_torch.fl import engine, simulator, strategies
from repro_torch.kernels.ref import select_score_ref
from repro_torch.openworld import adversary_mask

from test_torch_baselines import _mask_flips, reference_baseline_draws
from test_torch_support import reference_draws, to_numpy, to_torch

M, K, PROBE, BATCH, RATIO = 6, 2, 4, 8, 0.5
WIDTH = 32
FL_KW = dict(num_clients=M, peers_per_round=K, batch_size=BATCH,
             client_sample_ratio=RATIO, epochs_extractor=1, epochs_header=1,
             probe_size=PROBE, use_score_kernel=True)
RTOL, ATOL = 2e-3, 1e-5
ATTACK = dict(adversary_fraction=0.34, attack="sign_flip",
              score_game="both", cost_gain=1.5)
CHURN = dict(join_rate=0.5, leave_rate=0.3, init_alive=0.5)


@pytest.fixture(scope="module")
def setup():
    from repro.data.synthetic import client_datasets_cifar as ref_datasets

    ref_cfg = dataclasses.replace(ref_get_config("resnet18-cifar").reduced(),
                                  dtype="float32", image_size=8,
                                  cnn_width=WIDTH)
    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=8, cnn_width=WIDTH)
    data = ref_datasets(jax.random.PRNGKey(0), M, samples_per_class=20,
                        image_size=8)
    ref_train = {"images": data["train_x"], "labels": data["train_y"]}
    train = {k: to_torch(v) for k, v in ref_train.items()}
    return ref_cfg, cfg, data, ref_train, train


def _configs(threat=None, churn=None, **kw):
    fl_kw = dict(FL_KW, comms=None, **kw)
    return (FLConfig(threat=None if threat is None else ThreatConfig(**threat),
                     churn=None if churn is None else ChurnConfig(**churn),
                     **fl_kw),
            RefFLConfig(threat=None if threat is None
                        else RefThreatConfig(**threat),
                        churn=None if churn is None
                        else RefChurnConfig(**churn), **fl_kw))


def _assert_tree_close(got, want, what, skip=None):
    g = jax.tree_util.tree_leaves(got)
    w = jax.tree_util.tree_leaves(to_numpy(want))
    s = (jax.tree_util.tree_leaves(skip) if skip is not None
         else [None] * len(g))
    assert len(g) == len(w) == len(s), what
    for a, b, sk in zip(g, w, s):
        scale = float(np.abs(b).max()) if b.size else 0.0
        if sk is not None:
            a, b = a[~sk], b[~sk]
        np.testing.assert_allclose(a, b, rtol=RTOL,
                                   atol=max(ATOL, RTOL * scale),
                                   err_msg=what)


def _open_draws(key, spec, fl, params_np, pfeddst: bool):
    """The reference round's open-world draws under round key `key`: the
    churn uniforms and the gaussian noise (by the port's leaf paths,
    conv leaves in the port's layout)."""
    act = ref_named_streams(key, spec.key_streams)[spec.sample_stream]
    draws = {}
    if fl.churn is not None:
        k = jax.random.fold_in(act, ref_lifecycle._CHURN_SALT)
        kl, kj = jax.random.split(k)
        draws["churn"] = (np.asarray(jax.random.uniform(kl, (M,))),
                          np.asarray(jax.random.uniform(kj, (M,))))
    if fl.threat is not None and fl.threat.attack == "gaussian":
        k = jax.random.fold_in(act, ref_attacks._BYZ_SALT)
        leaves, treedef = jax.tree_util.tree_flatten(params_np)
        noise = jax.tree_util.tree_unflatten(treedef, [
            np.asarray(a) for a in _normals(tuple(leaf.shape
                                                  for leaf in leaves))(k)])
        parts = ({p: convert.params_from_reference(noise[p], device="cpu")
                  for p in ("e", "h")} if pfeddst else
                 {"": convert.params_from_reference(noise, device="cpu")})
        draws["byz"] = {(f"{p}/{n}" if p else n): t
                        for p, part in parts.items() for n, t in part.items()}
    return draws


_NORMALS = {}


def _normals(shapes):
    """A jitted draw of the reference's per-leaf normals (split of the key
    over the leaves, in order), compiled once per leaf layout."""
    if shapes not in _NORMALS:
        _NORMALS[shapes] = jax.jit(lambda k: [
            jax.random.normal(kk, shape, jnp.float32)
            for kk, shape in zip(jax.random.split(k, len(shapes)), shapes)])
    return _NORMALS[shapes]


def _margin(inner, active, cost_fl, threat):
    """Smallest gap between the k-th and (k+1)-th masked Eq. 9 score of
    the round on the spoofed view, over the active rows ranking more than
    k candidates (inf if none)."""
    flat = flatten_headers(inner.header)
    cost = cost_fl
    if threat is not None:
        flat, cost = threat.game_scores(flat, cost, M)
    s, _ = select_score_ref(flat, inner.last_selected, inner.loss_matrix,
                            inner.round, cost, None, alpha=1.0, lam=0.5)
    srt = torch.sort(s[active], dim=1, descending=True).values
    ranked = srt[:, K] > -1e29
    if not ranked.any():
        return float("inf")
    return float((srt[ranked, K - 1] - srt[ranked, K]).min())


def _run(setup, name, fl, rfl, rounds):
    """`rounds` rounds of strategy `name` in both packages; → the number
    of dispfl mask flips."""
    ref_cfg, cfg, _, ref_train, train = setup
    pfeddst = name.startswith("pfeddst")
    spec = ref_make_spec(name, ref_cfg, rfl, steps_per_epoch=1)
    ref_round = jax.jit(lambda st, k: ref_run_round(
        spec.stages, st, ref_train, k, m=M, ratio=RATIO,
        key_streams=spec.key_streams, sample_stream=spec.sample_stream))
    strat = strategies.make_strategy(name, cfg, fl, steps_per_epoch=1,
                                     device="cpu")
    rstate = spec.init(jax.random.PRNGKey(1))
    wrapped = isinstance(rstate, dict) and "inner" in rstate

    def port_state(r):
        inner = r["inner"] if wrapped else r
        inner = (convert.population_from_reference(to_numpy(inner),
                                                   device="cpu")
                 if pfeddst else
                 convert.baseline_state_from_reference(to_numpy(inner),
                                                       device="cpu"))
        if not wrapped:
            return inner
        return {"inner": inner, "alive": to_torch(r["alive"])}

    state = port_state(rstate)
    # dispfl: the reference up to its mask evolution, for the parameters
    # the masks evolve from (each stage depends on the state and the key)
    ref_head = jax.jit(lambda st, k: ref_run_round(
        spec.stages[:-2], st, ref_train, k, m=M, ratio=RATIO,
        key_streams=spec.key_streams, sample_stream=spec.sample_stream))
    flips = 0
    for r in range(rounds):
        key = jax.random.fold_in(jax.random.PRNGKey(2), r)
        rinner = rstate["inner"] if wrapped else rstate
        if pfeddst:
            params_np = {"e": to_numpy(rinner.extractor),
                         "h": to_numpy(rinner.header)}
            draws = reference_draws(key, m=M, ratio=RATIO,
                                    n_local=ref_train["images"].shape[1],
                                    probe_size=PROBE, batch_size=BATCH,
                                    n_e=1, n_h=1)
        else:
            params_np = to_numpy(rinner["params"])
            # regrow planes only where they are read (dispfl)
            draws = reference_baseline_draws(
                key, spec.key_streams,
                rinner["params"] if name == "dispfl" else {},
                n_local=ref_train["images"].shape[1], n_steps=1,
                regrow=rfl.dispfl_regrow)
        draws.update(_open_draws(key, spec, fl, params_np, pfeddst))
        before = state
        if name == "dispfl":
            pre = ref_head(rstate, key)[0]["inner"]["params"]
        rstate, rmet = ref_round(rstate, key)
        state, met = strat.round(state, train, (0, r), draws=draws)
        for k in ("active", "select_mask", "comm_edges"):
            assert (k in met) == (k in rmet), k
            if k in met:
                np.testing.assert_array_equal(met[k].numpy(),
                                              np.asarray(rmet[k]),
                                              err_msg=f"{k} round {r}")
        if wrapped:
            np.testing.assert_array_equal(state["alive"].numpy(),
                                          np.asarray(rstate["alive"]))
        if pfeddst and fl.churn is None:
            inner = before["inner"] if wrapped else before
            cost = fl.comm_cost
            ts = strat_threat(strat)
            # the loss rows of this round are what the scores saw
            view = inner._replace(
                loss_matrix=(state["inner"] if wrapped
                             else state).loss_matrix)
            margin = _margin(view, met["active"], cost, ts)
            assert margin > 1e-4, f"round {r}: near-tied scores ({margin})"
        inner = state["inner"] if wrapped else state
        rinner = rstate["inner"] if wrapped else rstate
        if pfeddst:
            got = convert.population_to_reference(inner)
            np.testing.assert_array_equal(got["last_selected"],
                                          np.asarray(rinner.last_selected))
            np.testing.assert_allclose(got["loss_matrix"],
                                       np.asarray(rinner.loss_matrix),
                                       rtol=RTOL, atol=ATOL)
            for field in ("extractor", "header"):
                _assert_tree_close(got[field], getattr(rinner, field), field)
            _assert_tree_close(got["opt_e"]["mu"], rinner.opt_e["mu"],
                               "opt_e")
            if got.get("store") is not None:
                for part in ("e", "h"):
                    _assert_tree_close(got["store"]["params"][part],
                                       rinner.store.params[part],
                                       f"store {part}")
        else:
            got = convert.baseline_state_to_reference(inner)
            skip = None
            if name == "dispfl":
                skip = _mask_flips(got["mask"], rinner["mask"], pre,
                                   1 - rfl.dispfl_sparsity)
                flips += sum(int(f.sum())
                             for f in jax.tree_util.tree_leaves(skip))
            _assert_tree_close(got["params"], rinner["params"], "params",
                               skip)
            ropt = rinner["opt"]["e"] if name == "fedbabu" else rinner["opt"]
            gopt = got["opt"]["e"] if name == "fedbabu" else got["opt"]
            _assert_tree_close(gopt["mu"], ropt["mu"], "opt mu")
            if skip is not None and any(
                    f.any() for f in jax.tree_util.tree_leaves(skip)):
                state = port_state(rstate)
        scalars = {k: v for k, v in rmet.items() if np.ndim(v) == 0}
        assert set(scalars) == {k for k, v in met.items() if v.dim() == 0}
        for k, v in scalars.items():
            np.testing.assert_allclose(float(met[k]), float(v), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    return flips


def strat_threat(strat):
    """The ThreatState a wrapped strategy publishes (None if honest)."""
    ctx = engine.RoundContext(m=M, data={}, streams={},
                              active=torch.ones(M, dtype=torch.bool),
                              sampled_idx=torch.arange(M))
    for stage in strat.stages:
        if getattr(stage, "__name__", "") == "ow_threat":
            stage(None, ctx)
    return ctx.threat


@pytest.mark.parametrize("defense", ["none", "median", "trimmed_mean",
                                     "norm_clip"])
def test_attacked_pfeddst_rounds_match_reference(setup, defense):
    fl, rfl = _configs(threat=dict(ATTACK, defense=defense))
    _run(setup, "pfeddst", fl, rfl, rounds=2)


@pytest.mark.parametrize("defense", ["median", "trimmed_mean", "norm_clip"])
def test_defended_fedavg_rounds_match_reference(setup, defense):
    fl, rfl = _configs(threat=dict(adversary_fraction=0.34, attack="scale",
                                   attack_scale=3.0, defense=defense))
    _run(setup, "fedavg", fl, rfl, rounds=2)


def test_dfedavgm_robust_mixer_rounds_match_reference(setup):
    """Under the gaussian attack, its noise injected from the reference's
    draws (by the port's leaf paths, conv leaves transposed)."""
    fl, rfl = _configs(threat=dict(adversary_fraction=0.34,
                                   attack="gaussian", noise_std=0.5,
                                   defense="trimmed_mean"))
    _run(setup, "dfedavgm", fl, rfl, rounds=2)


@pytest.mark.parametrize("name,kw", [
    ("pfeddst", dict(churn=dict(init_alive=0.99))),
    ("dispfl", dict(churn=dict(init_alive=0.99))),
    ("pfeddst", dict(threat=dict(adversary_fraction=0.34, attack="gaussian",
                                 noise_std=0.0))),
    ("dfedavgm", dict(threat=dict(adversary_fraction=0.34,
                                  attack="gaussian", noise_std=0.0))),
    ("fedavg", dict(churn=dict(init_alive=0.99),
                    threat=dict(adversary_fraction=0.34, attack="gaussian",
                                noise_std=0.0)))])
def test_zero_rate_wraps_equal_the_closed_run_bitwise(setup, name, kw):
    """A churn that keeps every slot alive (init_alive rounds to M, zero
    rates) and a gaussian attack of std 0 wrap the strategy, and the run
    equals the closed one bit for bit: masks every round, state at the
    end."""
    cfg, train = setup[1], setup[4]
    fl, _ = _configs(**kw)
    closed = strategies.make_strategy(name, cfg, FLConfig(**FL_KW), 1,
                                      device="cpu")
    opened = strategies.make_strategy(name, cfg, fl, 1, device="cpu")
    assert len(opened.stages) > len(closed.stages)
    s1, s2 = closed.init(3), opened.init(3)
    for r in range(2):
        s1, m1 = closed.round(s1, train, (4, r))
        s2, m2 = opened.round(s2, train, (4, r))
        for k in ("active", "select_mask", "comm_edges"):
            if k in m1:
                assert torch.equal(m1[k], m2[k]), (k, r)
    inner = s2["inner"]
    a = jax.tree_util.tree_leaves(to_tree(s1))
    b = jax.tree_util.tree_leaves(to_tree(inner))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def to_tree(state):
    """A port state as a jax-flattenable tree of tensors."""
    if isinstance(state, tuple):
        state = state._asdict()
    return {k: (to_tree(v) if isinstance(v, (dict, tuple)) else v)
            for k, v in state.items() if v is not None}


def test_run_experiment_eval_mask_and_adversary_trace(setup, monkeypatch,
                                                      tmp_path):
    """`eval_mask` reports the masked clients' mean accuracy (NaN when it
    selects none); the trace's selection graph names the adversary cast,
    and the reference's validator accepts the trace. On the default
    fabric, so the message bytes and the stage profile (2 rounds on
    throwaway state) run on the wrapped state."""
    cfg, data = setup[1], setup[2]
    fl = FLConfig(threat=ThreatConfig(**ATTACK), churn=ChurnConfig(**CHURN),
                  **FL_KW)
    seen = []
    real = simulator.evaluate_population

    def spy(*args):
        acc, accs = real(*args)
        seen.append(accs.numpy())
        return acc, accs

    monkeypatch.setattr(simulator, "evaluate_population", spy)
    honest = ~adversary_mask(M, ATTACK["adversary_fraction"], 0)
    path = tmp_path / "trace.jsonl"
    hist = simulator.run_experiment(
        "pfeddst", cfg, fl, {k: np.array(v) for k, v in data.items()},
        num_rounds=2, eval_every=1, steps_per_epoch=1, verbose=False,
        device="cpu", trace=str(path), trace_stages=True, eval_mask=honest)
    assert hist.accuracy == pytest.approx(
        [float(a[honest].mean()) for a in seen], rel=1e-6)
    assert min(hist.round_bytes) > 0
    for name in ("alive_frac", "joined_n", "adv_isolation", "adv_edge_frac"):
        assert len(hist.extra[name]) == 2
    records, errors = ref_validate_trace(str(path))
    assert not errors, errors
    assert records == [json.loads(line)
                       for line in path.read_text().splitlines()]
    stages = [r for r in records if r["type"] == "stage_profile"][0]
    assert {"ow_churn", "ow_byzantine", "ow_metrics"} <= set(stages["stages"])
    graph = [r for r in records if r["type"] == "selection_graph"][0]
    assert graph["adversaries"] == [int(i) for i in np.flatnonzero(~honest)]
    none = simulator.run_experiment(
        "fedavg", cfg, FLConfig(**FL_KW), {k: np.array(v)
                                           for k, v in data.items()},
        num_rounds=1, eval_every=1, steps_per_epoch=1, verbose=False,
        device="cpu", eval_mask=np.zeros(M, bool))
    assert np.isnan(none.accuracy[0])
