"""pfeddst_async rounds of the port against live rounds of the JAX
reference, with the reference's draws injected (`draws=`, and
`draws["net"]` on a fabric) and the state — its versioned peer store
included — carried across by each package on its own.

M = 6, k = 2, ratio 0.5, the reduced ResNet in f32 at width 32 (see
tests/test_torch_round.py for why not 16), `use_score_kernel=True` (the
fused select_topk route, fed the served headers). Three rounds in each of
three scenarios: a uniform device profile with an infinite deadline; a
bimodal profile with a finite deadline (stragglers gated out, served from
the store, their misses counted); a ring with hetero links, staleness
events and `stale_mode="serve"` (event lags pick older ring slots).
`active`, `select_mask` and the store's `pub_round` and `lag` must match
exactly; parameters, the store's snapshots, loss matrices and the scalar
metrics at the round tests' rtol 2e-3 (absolute floor 2e-3 × the leaf's
largest entry). Exact selection rests on well-separated Eq. 9 scores,
which the test checks on the served headers for the rows that rank more
than k candidates.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.comms.fabric import make_fabric as ref_make_fabric
from repro.configs import get_config as ref_get_config
from repro.configs.base import CommsConfig as RefCommsConfig
from repro.configs.base import DeviceProfile as RefDeviceProfile
from repro.configs.base import FLConfig as RefFLConfig
from repro.core.client_state import init_population as ref_init_population
from repro.core.partial_freeze import make_phase_steps as ref_phase_steps
from repro.core.rounds import PFEDDST_STREAMS as REF_STREAMS
from repro.core.rounds import make_pfeddst_stages as ref_stages
from repro.data.synthetic import client_datasets_cifar as ref_datasets
from repro.fl import hetero as ref_hetero
from repro.fl.engine import net_key as ref_net_key
from repro.fl.engine import run_round as ref_run_round
from repro.fl.strategies import make_strategy as ref_make_strategy
from repro.optim.sgd import sgd as ref_sgd
from repro_torch import convert
from repro_torch.configs import (CommsConfig, DeviceProfile, FLConfig,
                                 get_config)
from repro_torch.core.partial_freeze import make_phase_steps
from repro_torch.core.rounds import PFEDDST_STREAMS, make_pfeddst_stages
from repro_torch.core.scoring import flatten_headers
from repro_torch.fl import engine, hetero, simulator, strategies
from repro_torch.kernels.ref import select_score_ref
from repro_torch.obs.timers import stage_name
from repro_torch.optim.sgd import sgd

from test_torch_support import reference_draws, to_numpy, to_torch

M, K, PROBE, BATCH, RATIO = 6, 2, 4, 8, 0.5
WIDTH = 32
FL_KW = dict(num_clients=M, peers_per_round=K, batch_size=BATCH,
             client_sample_ratio=RATIO, epochs_extractor=1, epochs_header=1,
             probe_size=PROBE, use_score_kernel=True)
N_STEPS = 2          # K_e + K_h epochs of 1 step: local_train_steps
RTOL, ATOL = 2e-3, 1e-5
BIMODAL = dict(family="bimodal", straggler_fraction=0.5,
               straggler_slowdown=4.0, seed=2)
# (profile, deadline, comms): comms None is the fabric-less path
SCENARIOS = {
    "uniform_inf": (dict(), float("inf"), None),
    "bimodal_deadline": (BIMODAL, 1.0, None),
    "ring_serve": (BIMODAL, 1.0,
                   dict(topology="ring", ring_hops=2, link_model="hetero",
                        p_stale=0.4, max_staleness=3, stale_mode="serve",
                        availability=0.9, graph_seed=3)),
}


@pytest.fixture(scope="module")
def setup():
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


def _configs(scenario):
    prof, deadline, net = SCENARIOS[scenario]
    kw = dict(FL_KW, deadline_s=deadline)
    return (FLConfig(device_profile=DeviceProfile(**prof),
                     comms=None if net is None else CommsConfig(**net), **kw),
            RefFLConfig(device_profile=RefDeviceProfile(**prof),
                        comms=None if net is None else RefCommsConfig(**net),
                        **kw))


def _assert_tree_close(got, want, what):
    g = jax.tree_util.tree_leaves(got)
    w = jax.tree_util.tree_leaves(to_numpy(want))
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=RTOL,
                                   atol=max(ATOL, RTOL * scale),
                                   err_msg=what)


def _margin(served_h, last_selected, s_l, rnd, cost, cand, active):
    """Smallest gap between the k-th and (k+1)-th masked Eq. 9 score on
    the served headers, over the active rows ranking more than k
    candidates (inf if none)."""
    s, _ = select_score_ref(flatten_headers(served_h), last_selected, s_l,
                            rnd, cost, cand, alpha=1.0, lam=0.5)
    srt = torch.sort(s[active], dim=1, descending=True).values
    ranked = srt[:, K] > -1e29
    if not ranked.any():
        return float("inf")
    return float((srt[ranked, K - 1] - srt[ranked, K]).min())


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_async_rounds_match_reference(setup, scenario):
    ref_cfg, cfg, _, ref_train, train = setup
    fl, rfl = _configs(scenario)
    ropt = ref_sgd(rfl.lr, momentum=rfl.momentum,
                   weight_decay=rfl.weight_decay)
    rrt = ref_hetero.make_hetero_runtime(rfl, M, N_STEPS)
    rstages = ref_stages(ref_cfg, rfl, ref_phase_steps(ref_cfg, ropt),
                         steps_per_epoch=1, probe_size=PROBE,
                         use_score_kernel=True, hetero=rrt)
    rfab = None
    fab = None
    if rfl.comms is not None:
        rates = ref_hetero.sample_device_vectors(
            rfl.device_profile, M).channel_rate
        rfab = ref_make_fabric(rfl.comms, M, cost_scale=rfl.comm_cost,
                               channel_rate=rates)
        fab = strategies.make_strategy("pfeddst_async", cfg, fl, 1,
                                       device="cpu").fabric
        np.testing.assert_array_equal(fab.cost.numpy(),
                                      np.asarray(rfab.cost))
    ref_round = jax.jit(lambda st, k: ref_run_round(
        rstages, st, ref_train, k, m=M, ratio=RATIO, key_streams=REF_STREAMS,
        fabric=rfab, affinity=st.loss_matrix))
    opt = sgd(fl.lr, momentum=fl.momentum, weight_decay=fl.weight_decay)
    rt = hetero.make_hetero_runtime(fl, M, N_STEPS)
    stages = make_pfeddst_stages(cfg, fl, make_phase_steps(cfg, opt),
                                 steps_per_epoch=1, probe_size=PROBE,
                                 use_score_kernel=True, hetero=rt)
    assert [stage_name(s) for s in stages] == [
        "deadline_gate", "score_select", "aggregate", "phase_e", "phase_h",
        "publish", "update_context"]

    rstate = ref_init_population(ref_cfg, jax.random.PRNGKey(1), M, ropt,
                                 ropt)
    rstate = rstate._replace(store=ref_hetero.init_peer_store(
        {"e": rstate.extractor, "h": rstate.header}, rrt.depth))
    state = convert.population_from_reference(to_numpy(rstate),
                                              device="cpu")
    served_any = lagged = False
    for r in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(2), r)
        draws = reference_draws(key, m=M, ratio=RATIO,
                                n_local=ref_train["images"].shape[1],
                                probe_size=PROBE, batch_size=BATCH, n_e=1,
                                n_h=1)
        stale = torch.zeros(M, dtype=torch.int32)
        cand, cost = None, fl.comm_cost
        if rfab is not None:
            net = rfab.round_masks(ref_net_key(key),
                                   affinity=rstate.loss_matrix)
            draws["net"] = tuple(np.array(a) for a in net)
            cand = torch.from_numpy(draws["net"][0])
            stale = torch.from_numpy(draws["net"][2])
            cost = fab.cost
        before = state
        # the served headers, read before the round consumes the store
        served, _ = hetero.store_serve(state.store, int(state.round), stale)
        rstate, rmet = ref_round(rstate, key)
        state, met = engine.run_round(
            stages, state, train, (0, r), m=M, ratio=RATIO,
            key_streams=PFEDDST_STREAMS, draws=draws, fabric=fab,
            affinity=before.loss_matrix)
        active = met["active"]
        for k in ("active", "select_mask", "stale"):
            np.testing.assert_array_equal(met[k].numpy(),
                                          np.asarray(rmet[k]), err_msg=k)
        view = engine.where_tree(active, before.header, served["h"])
        margin = _margin(view, before.last_selected, state.loss_matrix,
                         before.round, cost, cand, active)
        assert margin > 1e-4, f"round {r}: near-tied scores ({margin})"
        got = convert.population_to_reference(state)
        np.testing.assert_array_equal(got["last_selected"],
                                      np.asarray(rstate.last_selected))
        np.testing.assert_allclose(got["loss_matrix"],
                                   np.asarray(rstate.loss_matrix),
                                   rtol=RTOL, atol=ATOL)
        for field in ("extractor", "header"):
            _assert_tree_close(got[field], getattr(rstate, field), field)
        for field in ("pub_round", "lag"):
            np.testing.assert_array_equal(
                got["store"][field], np.asarray(getattr(rstate.store, field)),
                err_msg=field)
        for part in ("e", "h"):
            _assert_tree_close(got["store"]["params"][part],
                               rstate.store.params[part], f"store {part}")
        scalars = {k: v for k, v in rmet.items() if np.ndim(v) == 0}
        assert set(scalars) == {k for k, v in met.items() if v.dim() == 0}
        for k, v in scalars.items():
            np.testing.assert_allclose(float(met[k]), float(v), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        served_any |= bool(float(met["serve_age_mean"]) > 0)
        lagged |= bool(float(met["eff_lag_mean"]) > 0)
    if scenario == "uniform_inf":
        assert float(met["eff_lag_mean"]) == 0.0
        assert float(met["round_wall_s"]) == float(met["straggler_wall_s"])
    else:
        # the scenario reaches what it is for: stale columns pulled
        assert served_any and lagged
        assert float(met["round_wall_s"]) <= fl.deadline_s


def test_async_uniform_infinite_deadline_bitwise_equals_pfeddst(setup):
    """With no device profile and deadline_s=inf, the port's
    pfeddst_async IS its pfeddst, bit for bit over three rounds; no wall
    metric is emitted; the store's latest slot equals the live state
    (each snapshot as old as the client's last training round)."""
    cfg, train = setup[1], setup[4]
    fl = FLConfig(**FL_KW)
    sync = strategies.make_strategy("pfeddst", cfg, fl, 1, device="cpu")
    asyn = strategies.make_strategy("pfeddst_async", cfg, fl, 1,
                                    device="cpu")
    assert asyn.versioned and not sync.versioned
    assert len(asyn.stages) == len(sync.stages) + 2
    s1, s2 = sync.init(1), asyn.init(1)
    assert s2.store is not None and s1.store is None
    for r in range(3):
        s1, m1 = sync.round(s1, train, (2, r))
        s2, m2 = asyn.round(s2, train, (2, r))
        assert torch.equal(m1["select_mask"], m2["select_mask"])
        assert float(m2["eff_lag_mean"]) == 0.0
        assert "round_wall_s" not in m2
    for field in ("extractor", "header"):
        for name, t in getattr(s1, field).items():
            assert torch.equal(t, getattr(s2, field)[name]), (field, name)
    assert torch.equal(s1.loss_matrix, s2.loss_matrix)
    assert torch.equal(s1.last_selected, s2.last_selected)
    served, age = hetero.store_serve(s2.store, int(s2.round))
    for name, t in served["e"].items():
        assert torch.equal(t, s2.extractor[name]), name
    # the true age of each snapshot: rounds since the client last trained
    assert (age >= 1).all() and (age <= 3).all()


def test_non_versioned_strategies_warn_as_the_reference(setup):
    """Stale serving and a finite deadline under a non-versioned strategy:
    the reference's two warnings, word for word; pfeddst_async emits
    neither."""
    ref_cfg, cfg = setup[0], setup[1]
    kw = dict(num_clients=M, deadline_s=2.0)
    fl = FLConfig(comms=CommsConfig(stale_mode="serve", p_stale=0.1), **kw)
    rfl = RefFLConfig(comms=RefCommsConfig(stale_mode="serve", p_stale=0.1),
                      **kw)
    for name in ("pfeddst", "dfedavgm", "fedavg"):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            strategies.make_strategy(name, cfg, fl, 1, device="cpu")
        with warnings.catch_warnings(record=True) as want:
            warnings.simplefilter("always")
            ref_make_strategy(name, ref_cfg, rfl, 1, jit=False)
        want = [str(w.message) for w in want
                if issubclass(w.category, UserWarning)]
        assert [str(w.message) for w in got] == want, name
        assert len(want) == 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        strategies.make_strategy("pfeddst_async", cfg, fl, 1, device="cpu")


@pytest.mark.parametrize("name", ["pfeddst", "pfeddst_async"])
def test_history_device_columns_follow_reference_formulas(setup, monkeypatch,
                                                          name):
    """`run_experiment` under a bimodal profile (pfeddst_async with a 1 s
    deadline): the device columns, from the reference's device vectors
    and wall times and the round's sampled (synchronous: active) set —
    the draws injected — are min(max wall over the sampled and online
    clients, deadline) for the semi-async rounds and the max wall over
    the active clients for the synchronous ones; device_time_s their
    running sum at each eval point; round_eff_lag the round's
    eff_lag_mean."""
    ref_cfg, cfg, data, ref_train, _ = setup
    fl, rfl = _configs("bimodal_deadline")
    if name == "pfeddst":
        fl = dataclasses.replace(fl, deadline_s=float("inf"))
        rfl = dataclasses.replace(rfl, deadline_s=float("inf"))
    k_rounds = jax.random.split(jax.random.PRNGKey(0), 3)[1]
    draws = {r: reference_draws(jax.random.fold_in(k_rounds, r), m=M,
                                ratio=RATIO,
                                n_local=ref_train["images"].shape[1],
                                probe_size=PROBE, batch_size=BATCH, n_e=2,
                                n_h=2)
             for r in range(3)}
    make = strategies.make_strategy

    def injected(*args, **kw):
        strat = make(*args, **kw)
        inner = strat.round
        strat.round = lambda st, d, key, _draws=None: inner(
            st, d, key, draws=draws[key[1]])
        return strat

    monkeypatch.setattr(simulator, "make_strategy", injected)
    actives = []
    hist = simulator.run_experiment(
        name, cfg, fl, {k: np.array(v) for k, v in data.items()},
        num_rounds=3, eval_every=2, steps_per_epoch=2, verbose=False,
        device="cpu", on_round=lambda r, met: actives.append(
            met["active"].numpy()))
    dv = ref_hetero.sample_device_vectors(rfl.device_profile, M)
    wall = ref_hetero.local_wall_times(
        dv, 2 * (rfl.epochs_extractor + (rfl.epochs_header
                                         if name.startswith("pfeddst")
                                         else 0)), rfl.device_profile)
    want_round, want_straggler = [], []
    for r in range(3):
        sampled = np.zeros(M, bool)
        sampled[draws[r]["act"]] = True
        pool = sampled if name == "pfeddst_async" else actives[r]
        straggler = float(np.float32(wall[pool].max()))
        want_straggler.append(straggler)
        want_round.append(min(straggler, fl.deadline_s))
        if name == "pfeddst_async":
            periods, offsets = ref_hetero.completion_schedule(
                ref_hetero.make_hetero_runtime(rfl, M, 4))
            done = np.mod(r - offsets, periods) == 0
            np.testing.assert_array_equal(actives[r], sampled & done)
    assert hist.round_device_wall_s == pytest.approx(want_round, rel=1e-7)
    assert hist.round_straggler_wall_s == pytest.approx(want_straggler,
                                                        rel=1e-7)
    assert hist.device_time_s == pytest.approx(
        [sum(want_round[:2]), sum(want_round)], rel=1e-6)
    if name == "pfeddst_async":
        assert hist.round_eff_lag == hist.extra["eff_lag_mean"]
        assert hist.extra["round_wall_s"] == hist.round_device_wall_s
    else:
        assert hist.round_eff_lag == [0.0] * 3
