"""Rounds on the comms fabric: the port against live rounds of the JAX
reference, with the reference's draws injected — its network draws
(candidates, availability, staleness) through `draws["net"]` — and the
state carried across by each package on its own.

M = 6, k = 2, ratio 0.5, the reduced ResNet in f32 at width 32 (see
tests/test_torch_round.py for why not 16). Two rounds each. Masks, edges
and `active` exact; parameters, momenta, loss matrices and scalar metrics
at the round tests' rtol 2e-3 (absolute floor 2e-3 × the leaf's largest
entry). Exact selection rests on well-separated Eq. 9 scores, which the
pfeddst cases check for the rows that rank more than k candidates.
`History`'s communication columns are compared exactly with the
reference's `run_experiment` for the same draws.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.comms.fabric import make_fabric as ref_make_fabric
from repro.configs import get_config as ref_get_config
from repro.configs.base import CommsConfig as RefCommsConfig
from repro.configs.base import FLConfig as RefFLConfig
from repro.core.client_state import init_population as ref_init_population
from repro.core.partial_freeze import make_phase_steps as ref_phase_steps
from repro.core.rounds import PFEDDST_STREAMS as REF_STREAMS
from repro.core.rounds import make_pfeddst_stages as ref_stages
from repro.data.synthetic import client_datasets_cifar as ref_datasets
from repro.fl.engine import net_key as ref_net_key
from repro.fl.engine import run_round as ref_run_round
from repro.fl.simulator import run_experiment as ref_run_experiment
from repro.fl.strategies import make_spec as ref_make_spec
from repro.kernels import ops as ref_ops
from repro.optim.sgd import sgd as ref_sgd
from repro_torch import comms, convert
from repro_torch.configs import CommsConfig, FLConfig, get_config
from repro_torch.core.partial_freeze import make_phase_steps
from repro_torch.core.rounds import PFEDDST_STREAMS, make_pfeddst_stages
from repro_torch.core.scoring import flatten_headers
from repro_torch.fl import engine, simulator, strategies
from repro_torch.kernels import gossip_mix as gm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import select_score_ref
from repro_torch.optim.sgd import sgd

from test_torch_baselines import (_assert_tree_close, _mask_flips,
                                  reference_baseline_draws)
from test_torch_support import reference_draws, to_numpy, to_torch

M, K, PROBE, BATCH, RATIO = 6, 2, 4, 8, 0.5
WIDTH = 32
FL_KW = dict(num_clients=M, peers_per_round=K, batch_size=BATCH,
             client_sample_ratio=RATIO, epochs_extractor=1, epochs_header=1,
             probe_size=PROBE)
# a ring of degree 4 (hops 2), so k = 2 still ranks candidates; hetero
# links (an Eq. 9 cost matrix) and every event
EVENTS = dict(link_model="hetero", p_link_drop=0.2, availability=0.9,
              p_stale=0.2, max_staleness=2, graph_seed=3)
COMMS = {"ring": dict(topology="ring", ring_hops=2, **EVENTS),
         "dynamic": dict(topology="dynamic", dyn_degree=2, dyn_explore=1,
                         **EVENTS)}
RTOL, ATOL = 2e-3, 1e-5


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


def _configs(comms_kw, **fl_kw):
    """(port FLConfig, reference FLConfig) with the same network."""
    kw = {**FL_KW, **fl_kw}
    return (FLConfig(comms=CommsConfig(**comms_kw), **kw),
            RefFLConfig(comms=RefCommsConfig(**comms_kw), **kw))


def _net_draws(rfab, key, affinity):
    """The reference round's network draws (its `net_key` stream)."""
    cand, avail, stale = rfab.round_masks(ref_net_key(key),
                                          affinity=affinity)
    return tuple(np.array(a) for a in (cand, avail, stale))


def _margin(state, s_l, cost, cand, active):
    """Smallest gap between the k-th and (k+1)-th masked Eq. 9 score over
    the active rows that rank more than k candidates (inf if none)."""
    s, _ = select_score_ref(flatten_headers(state.header),
                            state.last_selected, s_l, state.round, cost,
                            cand, alpha=1.0, lam=0.5)
    srt = torch.sort(s[active], dim=1, descending=True).values
    ranked = srt[:, K] > -1e29
    if not ranked.any():
        return float("inf")
    return float((srt[ranked, K - 1] - srt[ranked, K]).min())


def _assert_scalars(met, rmet):
    scalars = {k: v for k, v in rmet.items() if np.ndim(v) == 0}
    assert set(scalars) == {k for k, v in met.items() if v.dim() == 0}
    for k, v in scalars.items():
        np.testing.assert_allclose(float(met[k]), float(v), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("topo", ["ring", "dynamic"])
@pytest.mark.parametrize("mode", ["dense", "fused", "random"])
def test_pfeddst_rounds_on_a_fabric_match_reference(setup, topo, mode):
    """pfeddst through the dense Eq. 9 chain and through the fused
    select_topk route (which takes the candidate mask and the cost
    matrix), and pfeddst_random (raw_gram, then candidates), on a ring
    with hetero links and events and on the dynamic topology."""
    ref_cfg, cfg, _, ref_train, train = setup
    selection = "random" if mode == "random" else "topk"
    kernel = mode != "dense"
    fl, rfl = _configs(COMMS[topo], selection=selection,
                       use_score_kernel=kernel)
    ropt = ref_sgd(rfl.lr, momentum=rfl.momentum,
                   weight_decay=rfl.weight_decay)
    rstages = ref_stages(ref_cfg, rfl, ref_phase_steps(ref_cfg, ropt),
                         steps_per_epoch=1, probe_size=PROBE,
                         use_score_kernel=kernel)
    rfab = ref_make_fabric(rfl.comms, M, cost_scale=rfl.comm_cost)
    ref_round = jax.jit(lambda st, k: ref_run_round(
        rstages, st, ref_train, k, m=M, ratio=RATIO, key_streams=REF_STREAMS,
        fabric=rfab, affinity=st.loss_matrix))
    opt = sgd(fl.lr, momentum=fl.momentum, weight_decay=fl.weight_decay)
    stages = make_pfeddst_stages(cfg, fl, make_phase_steps(cfg, opt),
                                 steps_per_epoch=1, probe_size=PROBE,
                                 use_score_kernel=kernel)
    fab = comms.make_fabric(fl.comms, M, cost_scale=fl.comm_cost,
                            device="cpu")
    np.testing.assert_array_equal(fab.cost.numpy(), np.asarray(rfab.cost))

    rstate = ref_init_population(ref_cfg, jax.random.PRNGKey(1), M, ropt,
                                 ropt)
    state = convert.population_from_reference(to_numpy(rstate),
                                              device="cpu")
    for r in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(2), r)
        draws = reference_draws(key, m=M, ratio=RATIO,
                                n_local=ref_train["images"].shape[1],
                                probe_size=PROBE, batch_size=BATCH, n_e=1,
                                n_h=1)
        draws["net"] = _net_draws(rfab, key, rstate.loss_matrix)
        before = state
        rstate, rmet = ref_round(rstate, key)
        state, met = engine.run_round(
            stages, state, train, (0, r), m=M, ratio=RATIO,
            key_streams=PFEDDST_STREAMS, draws=draws, fabric=fab,
            affinity=before.loss_matrix)
        active = met["active"]
        np.testing.assert_array_equal(active.numpy(),
                                      np.asarray(rmet["active"]))
        np.testing.assert_array_equal(met["stale"].numpy(),
                                      np.asarray(rmet["stale"]))
        cand = torch.from_numpy(draws["net"][0])
        if mode != "random":
            margin = _margin(before, state.loss_matrix, fab.cost, cand,
                             active)
            assert margin > 1e-4, f"round {r}: near-tied scores ({margin})"
        mask = met["select_mask"]
        np.testing.assert_array_equal(mask.numpy(),
                                      np.asarray(rmet["select_mask"]))
        assert not (mask & ~cand).any()
        got = convert.population_to_reference(state)
        np.testing.assert_array_equal(got["last_selected"],
                                      np.asarray(rstate.last_selected))
        np.testing.assert_allclose(got["loss_matrix"],
                                   np.asarray(rstate.loss_matrix),
                                   rtol=RTOL, atol=ATOL)
        for field in ("extractor", "header"):
            _assert_tree_close(got[field], getattr(rstate, field), field)
        _assert_scalars(met, rmet)


@pytest.mark.parametrize("name,packed", [("dfedavgm", False),
                                         ("dfedavgm", True),
                                         ("dispfl", True)])
def test_gossip_rounds_on_a_ring_match_reference(setup, monkeypatch, name,
                                                 packed):
    """dfedavgm and dispfl on a ring (hops 1, degree 2) with events. With
    packing on the CPU as well (as it always is on a card), the undirected
    plans take the topology bound: D = degree + 1 = 3 ≤ M/2, so they mix
    through gossip_mix's plain version in the port and the reference's
    blocked mix; edges exact, state at rtol 2e-3 (dispfl's masks up to
    counted near-threshold flips, as in tests/test_torch_baselines.py)."""
    ref_cfg, cfg, _, ref_train, train = setup
    n_local = ref_train["images"].shape[1]
    ring = dict(COMMS["ring"], ring_hops=1)
    fl, rfl = _configs(ring)
    calls = []
    if packed:
        monkeypatch.setitem(ref_ops.AUTO_MIN_SPARSE_MIX, "cpu", 1)
        monkeypatch.setattr(ops, "MIN_PACKED_MIX_CPU", 1)
        plain = gm.gossip_mix_plain

        def spy(x, idx, w):
            calls.append(tuple(idx.shape))
            return plain(x, idx, w)

        monkeypatch.setattr(gm, "gossip_mix_plain", spy)
    spec = ref_make_spec(name, ref_cfg, rfl, steps_per_epoch=1)
    rfab = ref_make_fabric(rfl.comms, M, cost_scale=rfl.comm_cost)

    def run(stages):
        return jax.jit(lambda st, k: ref_run_round(
            stages, st, ref_train, k, m=M, ratio=RATIO,
            key_streams=spec.key_streams, fabric=rfab))

    # dispfl runs as two jits, the second from `evolve_masks` on, so the
    # mask check can read the parameters the masks evolve from
    split = len(spec.stages) - 2 if name == "dispfl" else len(spec.stages)
    head = run(spec.stages[:split])
    tail = run(spec.stages[split:]) if name == "dispfl" else None
    strat = strategies.make_strategy(name, cfg, fl, steps_per_epoch=1,
                                     device="cpu")
    assert strat.payload_fraction == spec.payload_fraction
    rstate = spec.init(jax.random.PRNGKey(1))
    state = convert.baseline_state_from_reference(to_numpy(rstate),
                                                  device="cpu")
    for r in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(2), r)
        draws = reference_baseline_draws(
            key, spec.key_streams, rstate["params"], n_local=n_local,
            n_steps=1, regrow=rfl.dispfl_regrow)
        draws["net"] = _net_draws(rfab, key, None)
        pre, rmet = head(rstate, key)
        rstate = tail(pre, key)[0] if tail is not None else pre
        state, met = strat.round(state, train, (0, r), draws=draws)
        for k in ("active", "comm_edges", "stale"):
            np.testing.assert_array_equal(met[k].numpy(),
                                          np.asarray(rmet[k]), err_msg=k)
        edges = met["comm_edges"]
        assert not (edges & ~torch.from_numpy(draws["net"][0])).any()
        got = convert.baseline_state_to_reference(state)
        skip = None
        if name == "dispfl":
            skip = _mask_flips(got["mask"], rstate["mask"], pre["params"],
                               1 - rfl.dispfl_sparsity)
            assert sum(int(f.sum()) for f in
                       jax.tree_util.tree_leaves(skip)) <= 8
        _assert_tree_close(got["params"], rstate["params"], "params", skip)
        _assert_tree_close(got["opt"]["mu"], rstate["opt"]["mu"], "opt mu")
        _assert_scalars(met, rmet)
        if skip is not None and any(f.any() for f in
                                    jax.tree_util.tree_leaves(skip)):
            state = convert.baseline_state_from_reference(to_numpy(rstate),
                                                          device="cpu")
    if packed:
        assert calls and set(calls) == {(M, 3)}, calls


def test_history_comm_columns_match_reference(setup, monkeypatch):
    """`run_experiment` on a ring with events: the per-round bytes,
    network time and staleness and the cumulative bytes, network time and
    energy equal the reference's `run_experiment` exactly, for fedavg
    (star accounting), dfedavgm (model payload) and dispfl (1 − sparsity
    of the extractor), whose edges the draws decide. The reference's
    round draws reach the port's rounds through a wrapper of
    `make_strategy`."""
    ref_cfg, cfg, data, _, _ = setup
    n_local = data["train_x"].shape[1]
    fl, rfl = _configs(COMMS["ring"])
    np_data = {k: np.array(v) for k, v in data.items()}
    k_init, k_rounds, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    rfab = ref_make_fabric(rfl.comms, M, cost_scale=rfl.comm_cost)
    for name in ("fedavg", "dfedavgm", "dispfl"):
        spec = ref_make_spec(name, ref_cfg, rfl, steps_per_epoch=1)
        draws = {}
        for r in range(2):
            key = jax.random.fold_in(k_rounds, r)
            draws[r] = reference_baseline_draws(
                key, spec.key_streams, spec.init(k_init)["params"],
                n_local=n_local, n_steps=1, regrow=rfl.dispfl_regrow)
            draws[r]["net"] = _net_draws(rfab, key, None)
        make = strategies.make_strategy

        def injected(*args, _draws=draws, **kw):
            strat = make(*args, **kw)
            inner = strat.round
            strat.round = lambda st, d, key, draws=None: inner(
                st, d, key, draws=_draws[key[1]])
            return strat

        monkeypatch.setattr(simulator, "make_strategy", injected)
        got = simulator.run_experiment(
            name, cfg, fl, np_data, num_rounds=2, eval_every=1,
            steps_per_epoch=1, verbose=False, device="cpu").to_dict()
        want = ref_run_experiment(name, ref_cfg, rfl, data, num_rounds=2,
                                  eval_every=1, steps_per_epoch=1,
                                  verbose=False).to_dict()
        for col in ("round_bytes", "round_net_time_s", "round_stale_lag",
                    "round_stale_max", "comm_bytes", "net_time_s",
                    "energy_j"):
            assert got[col] == want[col], (name, col, got[col], want[col])
        assert got["round_bytes"][0] > 0, name


def test_run_experiment_history_schema_default_fabric_on_cpu(setup):
    """The History schema test of tests/test_torch_round.py under the
    default `FLConfig.comms` (full topology, uniform links, no events):
    both pfeddst strategies report the same schema, and every round's
    bytes are what no draw decides there, each active client's k pulls
    of one extractor message; the cumulative column sums them."""
    _, cfg, _, _, _ = setup
    from repro_torch.data.synthetic import client_datasets_cifar
    from repro_torch.models import model as model_mod
    from repro_torch.models.split import split_params
    from repro_torch.utils.pytree import tree_bytes

    data = client_datasets_cifar(0, M, samples_per_class=20, image_size=8)
    fl = FLConfig(**FL_KW)
    assert fl.comms == CommsConfig()
    extractor = split_params(cfg, model_mod.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))[0]
    per_round = round(M * RATIO) * K * tree_bytes(extractor)
    for name in ("pfeddst", "pfeddst_random"):
        hist = simulator.run_experiment(
            name, cfg, fl, data, num_rounds=2, eval_every=1,
            steps_per_epoch=1, verbose=False, device="cpu").to_dict()
        assert hist["rounds"] == [1, 2]
        assert all(np.isfinite(hist["accuracy"]))
        assert hist["round_bytes"] == [per_round, per_round], name
        assert hist["comm_bytes"] == [per_round, 2 * per_round], name
        assert set(hist["extra"]) >= {"train_loss_e", "train_loss_h",
                                      "mean_selected_score",
                                      "sel_s_d_mean"}


def test_packed_fabric_round_equals_dense_fabric_round(setup):
    """pfeddst on hier_ring (clusters of 4) with availability and
    staleness events, p_link_drop = 0: the packed SparseFabric (the
    score_topk_sparse branch) and the dense fabric (the fused select_topk
    route) draw the same events, select the same peers, and leave the
    same state, bitwise."""
    from repro_torch.data.synthetic import client_datasets_cifar

    cfg = setup[1]
    m = 8
    d = client_datasets_cifar(0, m, samples_per_class=10, image_size=8)
    train8 = {"images": d["train_x"], "labels": d["train_y"]}
    net = dict(topology="hier_ring", hier_cluster=4, link_model="hetero",
               availability=0.9, p_stale=0.2, max_staleness=2,
               graph_seed=4)

    def run(sparse):
        fl = FLConfig(**{**FL_KW, "num_clients": m, "peers_per_round": 3,
                         "use_score_kernel": True},
                      comms=CommsConfig(sparse=sparse, **net))
        strat = strategies.make_strategy("pfeddst", cfg, fl, 1,
                                         device="cpu")
        assert hasattr(strat.fabric, "round_slots") == sparse
        state, masks = strat.init(1), []
        for r in range(2):
            state, met = strat.round(state, train8, (2, r))
            masks.append(met["select_mask"])
        return state, masks

    sd, md = run(False)
    ss, ms = run(True)
    for a, b in zip(md, ms):
        assert torch.equal(a, b)
    assert any(int(a.sum()) for a in md)
    got, want = convert.population_to_reference(ss), \
        convert.population_to_reference(sd)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_net_draws_replace_the_fabric_draws():
    """draws["net"] replaces a dense round's (cand, avail, stale) and a
    packed round's (slot_mask, avail, stale); the fabric's own draws come
    from `net_streams(key)` and take nothing from the strategy's
    streams."""
    m = 8
    seen = {}

    def probe(state, ctx):
        seen.update(cand=ctx.cand, nbr=ctx.nbr, active=ctx.active,
                    stale=ctx.stale, act=torch.rand(
                        3, generator=ctx.streams["act"]))
        ctx.plan = engine.ExchangePlan("p2p", active=ctx.active)
        return state

    data = {"x": torch.zeros(m, 1)}
    cfg = CommsConfig(topology="ring", availability=0.5, p_stale=0.5,
                      p_link_drop=0.3)
    for sparse in (False, True):
        fab = comms.make_fabric(dataclasses.replace(cfg, sparse=sparse), m,
                                device="cpu")
        engine.run_round((probe,), {}, data, (5, 1), m=m, ratio=1.0,
                         key_streams=("act",), fabric=fab)
        own = dict(seen)
        first, avail, stale = (fab.round_slots if sparse else
                               fab.round_masks)(engine.net_streams((5, 1)))
        assert torch.equal(own["cand"], fab.cand_dense(first) if sparse
                           else first)
        assert torch.equal(own["active"], avail)
        assert torch.equal(own["stale"], stale)
        engine.run_round((probe,), {}, data, (5, 1), m=m, ratio=1.0,
                         key_streams=("act",), fabric=None)
        assert torch.equal(seen["act"], own["act"])
        net = (torch.zeros_like(first), torch.ones(m, dtype=torch.bool),
               torch.full((m,), 2, dtype=torch.int32))
        engine.run_round((probe,), {}, data, (5, 1), m=m, ratio=1.0,
                         key_streams=("act",), fabric=fab,
                         draws={"net": net})
        assert not seen["cand"].any() and seen["active"].all()
        assert (seen["stale"] == 2).all()
        if sparse:
            assert torch.equal(seen["nbr"]["valid"], net[0])
            assert seen["nbr"]["idx"] is fab.nbr_idx


def test_run_round_sets_cand_bounded_only_for_static_fabric():
    """As the reference: a caller's mask is unbounded, a static fabric
    bounded (with the packed view on a SparseFabric), a dynamic one not."""
    m = 8
    seen = {}

    def probe(state, ctx):
        seen.update(bounded=ctx.cand_bounded, nbr=ctx.nbr)
        ctx.plan = engine.ExchangePlan("p2p", active=ctx.active)
        return state

    def run(fabric=None, **kw):
        seen.clear()
        engine.run_round((probe,), {}, {"x": torch.zeros(m)}, (0, 0), m=m,
                         ratio=1.0, key_streams=("act", "nbr"),
                         fabric=fabric, **kw)
        return dict(seen)

    got = run(candidate_mask=torch.ones(m, m, dtype=torch.bool))
    assert got["bounded"] is False and got["nbr"] is None
    got = run(comms.make_fabric(CommsConfig(topology="ring"), m,
                                device="cpu"))
    assert got["bounded"] is True and got["nbr"] is None
    got = run(comms.make_fabric(CommsConfig(topology="ring", sparse=True),
                                m, device="cpu"))
    assert got["bounded"] is True and got["nbr"]["idx"].shape == \
        got["nbr"]["valid"].shape
    got = run(comms.make_fabric(CommsConfig(topology="dynamic"), m,
                                device="cpu"))
    assert got["bounded"] is False


def test_gossip_plan_not_packed_for_unbounded_candidates(monkeypatch):
    """The reference's regression: a caller's all-pairs candidate mask
    with a (lying) ring bound of 2. Not fabric-cut, so the plan must not
    pack against the bound; packed against it, weight would be lost."""
    monkeypatch.setattr(ops, "MIN_PACKED_MIX_CPU", 1)
    m, k = 16, 12
    fl = FLConfig(num_clients=m, peers_per_round=k)
    stage = engine.stage_plan_gossip(fl, directed=False, topo_degree=2)
    ctx = engine.RoundContext(
        m=m, data=None, streams={"nbr": torch.Generator().manual_seed(0)},
        active=torch.ones(m, dtype=torch.bool), sampled_idx=torch.arange(m),
        cand=~torch.eye(m, dtype=torch.bool), cand_bounded=False)
    stage(None, ctx)
    assert ctx.plan.nbr_idx is None           # D = M: mixes dense
    ctx.cand_bounded = True                   # what a ring fabric would say
    stage(None, ctx)
    assert ctx.plan.nbr_idx.shape == (m, 3)
    # the hazard the gate guards against: packing at the lying bound
    full_w = torch.full((m, m), 1.0 / m)
    _, w = gm.weights_to_neighbors(full_w, 3)
    assert float(w.sum()) < float(full_w.sum()) - 0.5


def test_gather_neighbors_views_each_neighbourhood():
    m = 5
    tree = {"w": torch.arange(m * 2.0).reshape(m, 2), "t": torch.tensor(3)}
    idx = torch.tensor([[1, 2], [0, 0], [4, 3], [2, 2], [0, 1]],
                       dtype=torch.int32)
    out = engine.gather_neighbors(tree, idx, m)
    assert out["w"].shape == (m, 2, 2) and out["t"] is tree["t"]
    assert torch.equal(out["w"][2], tree["w"][[4, 3]])


@pytest.mark.parametrize("refusal", ["sparse_star", "serve", "device_profile",
                                     "threat"])
def test_refusals(refusal):
    """The reference's refusal of a packed fabric with a star strategy, and
    of an unknown attack in a ThreatConfig (the open world, item 11, is
    ported: a valid threat runs, on a packed fabric too). Since the
    semi-async layer's port, stale_mode="serve" with p_stale > 0 and a
    device profile are accepted as in the reference: a non-versioned
    strategy warns that stale peers serve live parameters
    (tests/test_torch_async_round.py holds the text to the reference's),
    and the packed fabric refuses a profile's channel rates."""
    import warnings

    from repro_torch.configs import DeviceProfile

    cfg = get_config("resnet18-cifar").reduced()
    if refusal == "serve":
        fl = FLConfig(num_clients=6, comms=CommsConfig(stale_mode="serve",
                                                       p_stale=0.1))
        with pytest.warns(UserWarning, match="LIVE parameters"):
            strategies.make_strategy("dfedavgm", cfg, fl, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            strategies.make_strategy("pfeddst_async", cfg, fl, device="cpu")
    elif refusal == "device_profile":
        prof = DeviceProfile(family="bimodal")
        strategies.make_strategy("pfeddst", cfg, FLConfig(
            num_clients=6, device_profile=prof), device="cpu")
        with pytest.raises(NotImplementedError, match="channel_rate"):
            strategies.make_strategy("pfeddst", cfg, FLConfig(
                num_clients=6, device_profile=prof,
                comms=CommsConfig(topology="ring", sparse=True)),
                device="cpu")
    elif refusal == "threat":
        from repro_torch.configs import ThreatConfig

        with pytest.raises(ValueError, match="unknown attack"):
            ThreatConfig(attack="bogus")
        strat = strategies.make_strategy("dispfl", cfg, FLConfig(
            num_clients=6, threat=ThreatConfig(adversary_fraction=0.5,
                                               attack="sign_flip"),
            comms=CommsConfig(topology="ring", sparse=True)), device="cpu")
        assert "ow_byzantine" in [getattr(s, "stage_name", s.__name__)
                                  for s in strat.stages]
    else:
        with pytest.raises(ValueError, match="sparse"):
            strategies.make_strategy("fedavg", cfg, FLConfig(
                num_clients=6, comms=CommsConfig(topology="ring",
                                                 sparse=True)),
                device="cpu")
    # serve mode without staleness events is accepted (nothing is stale)
    strategies.make_strategy("dfedavgm", cfg, FLConfig(
        num_clients=6, comms=CommsConfig(stale_mode="serve")), device="cpu")
