"""The semi-async layer's modules (`repro_torch.fl.hetero`, the
staleness weights of `core.aggregation`) against the JAX reference's
`repro.fl.hetero`, on the same inputs made from a seed with numpy.

Device vectors, wall times, the completion schedule, the peer store's
serve and publish, `pull_staleness` and the deadline gate are integer or
exactly rounded float32 arithmetic on both sides: they must be equal bit
for bit. `staleness_weights` with lag 0 must be bit for bit the
reference's and `selection_to_weights`; with lag > 0 `torch.pow` and
XLA's `pow` may differ in the last ulp, so those are held to rtol 1e-6.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DeviceProfile as RefDeviceProfile
from repro.configs.base import FLConfig as RefFLConfig
from repro.core import aggregation as ref_agg
from repro.fl import engine as ref_engine
from repro.fl import hetero as ref_hetero
from repro_torch.configs import (CommsConfig, DeviceProfile, FLConfig,
                                 get_config)
from repro_torch.core.aggregation import (selection_to_weights,
                                          staleness_weights)
from repro_torch.data.synthetic import client_datasets_cifar
from repro_torch.fl import engine, hetero, strategies

PROFILES = {
    "uniform": dict(),
    "bimodal": dict(family="bimodal", straggler_fraction=0.25,
                    straggler_slowdown=4.0, seed=3),
    "bimodal_fixed_rate": dict(family="bimodal", straggler_fraction=0.5,
                               straggler_slowdown=3.0,
                               rate_follows_speed=False, seed=1),
    "zipf": dict(family="zipf", zipf_exponent=1.2, seed=7),
}


def _profiles(name):
    kw = PROFILES[name]
    return DeviceProfile(**kw), RefDeviceProfile(**kw)


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("m", [6, 16, 33])
def test_device_vectors_bitwise_equal_reference(name, m):
    prof, rprof = _profiles(name)
    got = hetero.sample_device_vectors(prof, m)
    want = ref_hetero.sample_device_vectors(rprof, m)
    for field in ("speed", "channel_rate", "energy_scale"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype == np.float32, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    for n_steps in (1, 12):
        np.testing.assert_array_equal(
            hetero.local_wall_times(got, n_steps, prof),
            ref_hetero.local_wall_times(want, n_steps, rprof))


def test_unknown_family_raises():
    with pytest.raises(KeyError, match="zap"):
        hetero.sample_device_vectors(DeviceProfile(family="zap"), 4)


@pytest.mark.parametrize("deadline", [0.0, 0.7, 1.0, 2.0, float("inf")])
@pytest.mark.parametrize("name", ["uniform", "bimodal", "zipf"])
def test_runtime_and_completion_schedule_equal_reference(name, deadline):
    """make_hetero_runtime and completion_schedule: the wall times,
    deadline (≤ 0 → inf), exponent, depth, `profiled`, and the periods
    and offsets, exactly."""
    prof, rprof = _profiles(name)
    m, n_steps = 16, 12
    kw = dict(num_clients=m, deadline_s=deadline, staleness_alpha=0.7,
              version_depth=3)
    for p, rp in ((prof, rprof), (None, None)):
        rt = hetero.make_hetero_runtime(FLConfig(device_profile=p, **kw), m,
                                        n_steps)
        rrt = ref_hetero.make_hetero_runtime(
            RefFLConfig(device_profile=rp, **kw), m, n_steps)
        np.testing.assert_array_equal(rt.wall_s, rrt.wall_s)
        assert (rt.deadline_s, rt.alpha, rt.depth, rt.profiled) == \
            (rrt.deadline_s, rrt.alpha, rrt.depth, rrt.profiled)
        for a, b in zip(hetero.completion_schedule(rt),
                        ref_hetero.completion_schedule(rrt)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_paper_scale_schedule_periods():
    """The chip run's bimodal profile at M=16 with 12 local steps: fast
    clients take 1.7 s, slow ones 6.8 s; under a 2 s deadline the periods
    are 1 and 4."""
    prof = DeviceProfile(family="bimodal", straggler_fraction=0.25,
                         straggler_slowdown=4.0)
    rt = hetero.make_hetero_runtime(
        FLConfig(num_clients=16, device_profile=prof, deadline_s=2.0), 16,
        12)
    slow = rt.devices.speed < 1
    assert slow.sum() == 4
    np.testing.assert_allclose(rt.wall_s[~slow], 1.7, rtol=1e-6)
    np.testing.assert_allclose(rt.wall_s[slow], 6.8, rtol=1e-6)
    periods, _ = hetero.completion_schedule(rt)
    assert set(periods[~slow]) == {1} and set(periods[slow]) == {4}


# ---------------------------------------------------------------------------
# the versioned peer store
# ---------------------------------------------------------------------------

def _trees(m, rng):
    """The same tree for both packages: a (M, 3, 2) and an (M,) leaf."""
    a = {"e": {"w": rng.normal(size=(m, 3, 2)).astype(np.float32)},
         "h": {"b": rng.normal(size=(m,)).astype(np.float32)}}
    return ({k: {n: torch.from_numpy(v.copy()) for n, v in d.items()}
             for k, d in a.items()},
            {k: {n: jnp.asarray(v) for n, v in d.items()}
             for k, d in a.items()})


def _assert_store_equal(got, want):
    for k in ("e", "h"):
        for n in got.params[k]:
            np.testing.assert_array_equal(got.params[k][n].numpy(),
                                          np.asarray(want.params[k][n]))
    np.testing.assert_array_equal(got.pub_round.numpy(),
                                  np.asarray(want.pub_round))
    np.testing.assert_array_equal(got.lag.numpy(), np.asarray(want.lag))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_store_serve_and_publish_equal_reference(depth):
    """Eleven rounds of random publishes (fresh, blocked, neither) and
    serves with random event lags up to 9 (clipped to V − 1), from round
    0 (slot −1 mod V) through several ring wraparounds: the served trees,
    ages, slots, pub_round and lag counters equal the reference's."""
    m = 7
    rng = np.random.default_rng(depth)
    tree, rtree = _trees(m, rng)
    store = hetero.init_peer_store(tree, depth)
    rstore = ref_hetero.init_peer_store(rtree, depth)
    _assert_store_equal(store, rstore)
    for rnd in range(11):
        lag = rng.integers(0, 10, size=m).astype(np.int32)
        for ev in (None, lag):
            served, age = hetero.store_serve(
                store, rnd, None if ev is None else torch.from_numpy(ev))
            rserved, rage = ref_hetero.store_serve(
                rstore, jnp.int32(rnd), None if ev is None else
                jnp.asarray(ev))
            np.testing.assert_array_equal(age.numpy(), np.asarray(rage))
            for k in ("e", "h"):
                for n in served[k]:
                    np.testing.assert_array_equal(
                        served[k][n].numpy(), np.asarray(rserved[k][n]))
        new, rnew = _trees(m, rng)
        fresh = rng.random(m) < 0.5
        blocked = ~fresh & (rng.random(m) < 0.5)
        store = hetero.store_publish(store, new, torch.from_numpy(fresh),
                                     torch.from_numpy(blocked), rnd)
        rstore = ref_hetero.store_publish(rstore, rnew, jnp.asarray(fresh),
                                          jnp.asarray(blocked),
                                          jnp.int32(rnd))
        _assert_store_equal(store, rstore)


def test_store_publish_writes_in_place_and_lag0_serve_is_bitwise():
    """publish writes slot rnd % V of the input store's tensors (the
    round consumes its store), and a lag-0 serve after it returns the
    published bf16 rows bit for bit."""
    m, depth = 5, 3
    tree = {"w": torch.randn(m, 4, generator=torch.Generator().manual_seed(0)
                             ).to(torch.bfloat16)}
    store = hetero.init_peer_store(tree, depth)
    slots = store.params["w"]
    for rnd in range(2 * depth + 1):
        new = {"w": (tree["w"] * (rnd + 2)).to(torch.bfloat16)}
        store = hetero.store_publish(store, new,
                                     torch.ones(m, dtype=torch.bool),
                                     torch.zeros(m, dtype=torch.bool), rnd)
        assert store.params["w"] is slots
        served, age = hetero.store_serve(store, rnd + 1)
        assert torch.equal(served["w"].view(torch.int16),
                           new["w"].view(torch.int16))
        assert (age == 1).all()


def test_pull_staleness_equals_reference():
    """Deadline misses plus clipped event lags; active columns carry no
    channel lag (but keep their misses)."""
    rng = np.random.default_rng(0)
    m, depth = 9, 4
    tree, rtree = _trees(m, rng)
    miss = rng.integers(0, 4, size=m).astype(np.int32)
    store = hetero.init_peer_store(tree, depth)._replace(
        lag=torch.from_numpy(miss))
    rstore = ref_hetero.init_peer_store(rtree, depth)._replace(
        lag=jnp.asarray(miss))
    ev = rng.integers(0, 9, size=m).astype(np.int32)
    active = rng.random(m) < 0.5
    for stale in (None, ev):
        for act in (None, active):
            got = hetero.pull_staleness(
                store, None if stale is None else torch.from_numpy(stale),
                depth, active=None if act is None else torch.from_numpy(act))
            want = ref_hetero.pull_staleness(
                rstore, None if stale is None else jnp.asarray(stale), depth,
                active=None if act is None else jnp.asarray(act))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = hetero.pull_staleness(store, torch.from_numpy(ev), depth,
                                active=torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy()[active], miss[active])


# ---------------------------------------------------------------------------
# staleness-weighted aggregation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [6, 16])
def test_staleness_weights_equal_reference(m):
    rng = np.random.default_rng(m)
    mask = rng.random((m, m)) > 0.5
    tmask, jmask = torch.from_numpy(mask), jnp.asarray(mask)
    zero = np.zeros(m, np.int32)
    w0 = staleness_weights(tmask, torch.from_numpy(zero), alpha=0.5)
    # lag 0: bit for bit the reference's and selection_to_weights
    assert torch.equal(w0, selection_to_weights(tmask, include_self=True))
    np.testing.assert_array_equal(
        w0.numpy(), np.asarray(ref_agg.staleness_weights(
            jmask, jnp.asarray(zero), alpha=0.5)))
    lag = rng.integers(0, 5, size=m).astype(np.int32)
    frac = rng.random(m).astype(np.float32) + 0.1
    for alpha in (0.5, 1.0, 2.3):
        for fr in (None, frac):
            got = staleness_weights(
                tmask, torch.from_numpy(lag), alpha=alpha,
                data_fractions=None if fr is None else torch.from_numpy(fr))
            want = ref_agg.staleness_weights(
                jmask, jnp.asarray(lag), alpha=alpha,
                data_fractions=None if fr is None else jnp.asarray(fr))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-6)
    # the diagonal is never discounted: a stale client's own column keeps
    # the weight of a fresh one
    full = torch.ones(3, 3, dtype=torch.bool) & ~torch.eye(3, dtype=torch.bool)
    w = staleness_weights(full, torch.tensor([0, 3, 0]), alpha=1.0)
    assert float(w[0, 1]) == pytest.approx(float(w[0, 2]) * 0.25, rel=1e-6)
    assert float(w[1, 1]) == pytest.approx(1 / 3, rel=1e-6)


def test_selection_to_weights_column_scale_and_fractions_equal_reference():
    """The reference's order: max(mask, eye), × where(eye, 1, scale),
    × fractions, / max(row sum, 1e-12); rows with nothing selected and no
    self stay all-zero."""
    rng = np.random.default_rng(5)
    m = 8
    mask = rng.random((m, m)) > 0.6
    mask[3] = False
    scale = rng.random(m).astype(np.float32)
    frac = rng.random(m).astype(np.float32)
    for include_self in (True, False):
        for sc in (None, scale):
            for fr in (None, frac):
                got = selection_to_weights(
                    torch.from_numpy(mask), include_self=include_self,
                    column_scale=None if sc is None else torch.from_numpy(sc),
                    data_fractions=None if fr is None else
                    torch.from_numpy(fr))
                want = ref_agg.selection_to_weights(
                    jnp.asarray(mask), include_self=include_self,
                    column_scale=None if sc is None else jnp.asarray(sc),
                    data_fractions=None if fr is None else jnp.asarray(fr))
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the deadline gate
# ---------------------------------------------------------------------------

def _runtimes(wall, deadline, profiled=True):
    m = len(wall)
    dv = hetero.sample_device_vectors(DeviceProfile(), m)
    rdv = ref_hetero.sample_device_vectors(RefDeviceProfile(), m)
    w = np.asarray(wall, np.float32)
    return (hetero.HeteroRuntime(devices=dv, wall_s=w, deadline_s=deadline,
                                 alpha=0.5, depth=4, profiled=profiled),
            ref_hetero.HeteroRuntime(devices=rdv, wall_s=w,
                                     deadline_s=deadline, alpha=0.5,
                                     depth=4, profiled=profiled))


@pytest.mark.parametrize("deadline,profiled", [(1.1, True), (2.5, True),
                                               (float("inf"), True),
                                               (1.1, False)])
def test_deadline_gate_equals_reference(deadline, profiled):
    """Eight rounds of the gate from random sampled ∧ online masks:
    `active`, `deadline_blocked`, `straggler_wall_s`, `round_wall_s`
    (present only when profiled) equal the reference gate's; an infinite
    deadline leaves `active` as it was."""
    wall = [1.0, 4.0, 1.0, 4.0, 2.2, 0.3, 9.0]
    m = len(wall)
    rt, rrt = _runtimes(wall, deadline, profiled)
    gate = hetero.stage_deadline_gate(rt, get_round=lambda s: s["round"])
    rgate = ref_hetero.stage_deadline_gate(rrt,
                                           get_round=lambda s: s["round"])
    assert gate.stage_name == rgate.stage_name == "deadline_gate"
    rng = np.random.default_rng(1)
    for r in range(8):
        pre = rng.random(m) < 0.7
        ctx = engine.RoundContext(m=m, data=None, streams={},
                                  active=torch.from_numpy(pre),
                                  sampled_idx=torch.arange(m))
        rctx = ref_engine.RoundContext(m=m, data={}, keys={},
                                       active=jnp.asarray(pre),
                                       sampled_idx=jnp.arange(m))
        gate({"round": torch.tensor(r, dtype=torch.int32)}, ctx)
        rgate({"round": jnp.int32(r)}, rctx)
        for got, want in ((ctx.active, rctx.active),
                          (ctx.aux["deadline_blocked"],
                           rctx.aux["deadline_blocked"])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert set(ctx.metrics) == set(rctx.metrics)
        for k in ctx.metrics:
            assert float(ctx.metrics[k]) == float(rctx.metrics[k]), k
        assert ctx.devices is rt.devices
        if not np.isfinite(deadline):
            np.testing.assert_array_equal(ctx.active.numpy(), pre)


def test_deadline_gate_composes_onto_dfedavgm_stages():
    """The reference's composition test on the port: the gate put before
    dfedavgm's stages, run through `engine.run_round` on the default
    fabric. At round 0 the stragglers with nonzero offsets are gated
    out, the round lasts the deadline, gated clients exchange nothing and
    keep their parameters."""
    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=8)
    m = 6
    fl = FLConfig(num_clients=m, peers_per_round=2, batch_size=8,
                  client_sample_ratio=1.0, epochs_extractor=1,
                  epochs_header=1)
    strat = strategies.make_strategy("dfedavgm", cfg, fl, 1, device="cpu")
    dv = hetero.sample_device_vectors(
        DeviceProfile(family="bimodal", straggler_fraction=0.5,
                      straggler_slowdown=4.0), m)
    rt = hetero.HeteroRuntime(
        devices=dv, wall_s=hetero.local_wall_times(dv, 2, DeviceProfile()),
        deadline_s=0.8, alpha=0.5, depth=2)
    gate = hetero.stage_deadline_gate(rt, get_round=lambda s: s["round"])
    data = client_datasets_cifar(0, m, samples_per_class=10, image_size=8)
    train = {"images": torch.as_tensor(data["train_x"]),
             "labels": torch.as_tensor(data["train_y"])}
    state = strat.init(1)
    new, metrics = engine.run_round(
        (gate,) + strat.stages, state, train, (2, 0), m=m, ratio=1.0,
        key_streams=strat.key_streams, fabric=strat.fabric)
    active = metrics["active"]
    periods, offsets = hetero.completion_schedule(rt)
    np.testing.assert_array_equal(active.numpy(), offsets == 0)
    assert 0 < int(active.sum()) < m
    assert float(metrics["round_wall_s"]) == pytest.approx(0.8)
    assert not metrics["comm_edges"][~active].any()
    for name, p in new["params"].items():
        assert torch.equal(p[~active], state["params"][name][~active]), name


def test_make_strategy_scales_the_fabric_by_channel_rates():
    """A device profile's channel rates reach the dense fabric's links and
    Eq. 9 cost (as the reference's make_strategy passes them); a uniform
    profile changes nothing; the packed fabric refuses rates."""
    from repro.comms.fabric import make_fabric as ref_make_fabric
    from repro.configs.base import CommsConfig as RefCommsConfig

    cfg = get_config("resnet18-cifar").reduced()
    m = 8
    prof, rprof = _profiles("bimodal")
    net = dict(topology="ring", link_model="hetero")
    fl = FLConfig(num_clients=m, device_profile=prof,
                  comms=CommsConfig(**net))
    strat = strategies.make_strategy("pfeddst_async", cfg, fl, 1,
                                     device="cpu")
    rates = ref_hetero.sample_device_vectors(rprof, m).channel_rate
    rfab = ref_make_fabric(RefCommsConfig(**net), m, channel_rate=rates)
    np.testing.assert_array_equal(strat.fabric.cost.numpy(),
                                  np.asarray(rfab.cost))
    plain = strategies.make_strategy(
        "pfeddst_async", cfg, dataclasses.replace(fl, device_profile=None),
        1, device="cpu")
    assert not torch.equal(plain.fabric.cost, strat.fabric.cost)
    uniform = strategies.make_strategy(
        "pfeddst_async", cfg,
        dataclasses.replace(fl, device_profile=DeviceProfile()), 1,
        device="cpu")
    assert torch.equal(plain.fabric.cost, uniform.fabric.cost)
    with pytest.raises(NotImplementedError, match="channel_rate"):
        strategies.make_strategy(
            "pfeddst_async", cfg, dataclasses.replace(
                fl, comms=CommsConfig(topology="ring", sparse=True)), 1,
            device="cpu")
