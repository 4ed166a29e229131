"""The port's open-world layer (`repro_torch.openworld`) against the JAX
reference's (`repro.openworld`), unit by unit, on the same inputs (numpy
arrays from a seed, both packages in-process): the adversary cast, score
gaming, byzantine corruption (the gaussian noise injected from the
reference's draws), the star reducers and the per-row robust aggregate,
the isolation metrics, the lifecycle primitives, the config validation,
and the composition (the identity when inert, the wrapped stage order
when threatened). The scenarios follow the reference's
tests/test_openworld.py.

Tolerances: the cast, spoofed headers' honest rows, corrupted rows of
sign_flip / scale / gaussian, the medians and the isolation scalars are
exact (the median as a value: the reference's one-hot rank sum turns a
−0.0 into +0.0, the port's gather keeps it); the spoofed header mean, the
trimmed means, the norms and the norm-clipped means sum in another order
than XLA and are held at rtol 1e-5 (absolute floor 1e-6 × the largest
entry).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import ChurnConfig as RefChurnConfig
from repro.configs.base import FLConfig as RefFLConfig
from repro.configs.base import ThreatConfig as RefThreatConfig
from repro.fl.engine import RoundContext as RefRoundContext
from repro.fl.strategies import make_spec as ref_make_spec
from repro.obs.timers import stage_name as ref_stage_name
from repro import openworld as ref_ow
from repro.openworld import attacks as ref_attacks
from repro.openworld import defense as ref_defense
from repro.utils.pytree import tree_paths as ref_tree_paths
from repro_torch.configs import (ChurnConfig, FLConfig, ThreatConfig,
                                 get_config)
from repro_torch.fl import strategies
from repro_torch.fl.engine import RoundContext
from repro_torch.obs.timers import stage_name
from repro_torch import openworld as ow
from repro_torch.openworld import attacks, defense
from repro_torch.utils.pytree import tree_paths

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=max(1e-7, 1e-6 * scale))


def _ctx(m, active=None, cand=None, draws=None):
    active = torch.ones(m, dtype=torch.bool) if active is None else \
        torch.as_tensor(active)
    return RoundContext(m=m, data={}, streams={}, active=active,
                        sampled_idx=torch.arange(m), cand=cand,
                        draws=draws or {}, key=(0, 0))


def _ref_ctx(m, active=None):
    key = jax.random.PRNGKey(0)
    active = jnp.ones((m,), bool) if active is None else jnp.asarray(active)
    return RefRoundContext(m=m, data={}, keys={"act": key}, active=active,
                           sampled_idx=jnp.arange(m))


# ---------------------------------------------------------------------------
# adversary cast + score gaming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,fraction,seed", [(12, 0.25, 3), (16, 0.25, 0),
                                             (7, 0.5, 11), (5, 0.0, 0),
                                             (9, 1.0, 2), (100, 0.1, 5)])
def test_adversary_mask_bitwise(m, fraction, seed):
    got = attacks.adversary_mask(m, fraction, seed)
    np.testing.assert_array_equal(
        got, ref_attacks.adversary_mask(m, fraction, seed))
    assert got.dtype == bool and got.sum() == round(m * fraction)


@pytest.mark.parametrize("game", ["header", "cost", "both"])
@pytest.mark.parametrize("matrix_cost", [False, True])
def test_game_scores_match_reference(game, matrix_cost):
    m, p = 7, 9
    rng = np.random.default_rng(4)
    flat = rng.normal(size=(m, p)).astype(np.float32)
    adv = attacks.adversary_mask(m, 0.3, 1)
    cost = (rng.uniform(0.2, 2.0, size=(m, m)).astype(np.float32)
            if matrix_cost else 0.7)
    ts = attacks.ThreatState(adversaries=torch.from_numpy(adv),
                             score_game=game, cost_gain=1.5)
    rts = ref_attacks.ThreatState(adversaries=jnp.asarray(adv),
                                  score_game=game, cost_gain=1.5)
    got_f, got_c = ts.game_scores(
        torch.from_numpy(flat),
        torch.from_numpy(cost) if matrix_cost else cost, m)
    want_f, want_c = rts.game_scores(
        jnp.asarray(flat), jnp.asarray(cost) if matrix_cost else cost, m)
    np.testing.assert_array_equal(got_f.numpy()[~adv], flat[~adv])
    _close(got_f.numpy(), want_f)
    if game == "header":
        assert got_c is cost or torch.equal(got_c, torch.from_numpy(cost))
    else:
        assert got_c.shape == (m, m) and got_c.dtype == torch.float32
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        best = float(np.max(cost))
        assert np.all(got_c.numpy()[:, adv] == np.float32(best) * 1.5)


# ---------------------------------------------------------------------------
# byzantine corruption
# ---------------------------------------------------------------------------

def _reference_noise(ctx_keys, post_np):
    """The reference's gaussian draws for `post`, by the port's paths."""
    key = jax.random.fold_in(ctx_keys["act"], ref_attacks._BYZ_SALT)
    pairs = ref_tree_paths(post_np)
    keys = jax.random.split(key, len(pairs))
    return {p: np.asarray(jax.random.normal(k, leaf.shape, jnp.float32))
            for (p, leaf), k in zip(pairs, keys)}


@pytest.mark.parametrize("attack", ["sign_flip", "scale", "gaussian"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage_byzantine_matches_reference(attack, dtype):
    """Every attack on a two-leaf population (f32 and bf16): the active
    adversary's rows equal the reference's, bit for bit; honest rows and
    the inactive adversary keep the trained update bit for bit."""
    m = 6
    rng = np.random.default_rng(1)
    pre_np = {"w": rng.normal(size=(m, 3, 2)).astype(np.float32),
              "b": rng.normal(size=(m, 4)).astype(np.float32)}
    post_np = {k: v + rng.normal(size=v.shape).astype(np.float32)
               for k, v in pre_np.items()}
    adv = np.array([True, True, False, False, False, False])
    active = np.array([True, False, True, True, True, True])
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)

    rts = ref_attacks.ThreatState(adversaries=jnp.asarray(adv),
                                  attack=attack, attack_scale=2.0,
                                  noise_std=0.5)
    get_p, set_p = (lambda s: s["params"]), (lambda s, p: {**s, "params": p})
    rctx = _ref_ctx(m, active)
    rstate = {"params": {k: jnp.asarray(v, jdt) for k, v in pre_np.items()}}
    rstate = ref_attacks.stage_snapshot(get_p)(rstate, rctx)
    rstate = {"params": {k: jnp.asarray(v, jdt) for k, v in post_np.items()}}
    want = ref_attacks.stage_byzantine(rts, get_p, set_p)(rstate, rctx)

    noise = _reference_noise(rctx.keys, {k: np.asarray(v) for k, v in
                                         rstate["params"].items()})
    ts = attacks.ThreatState(adversaries=torch.from_numpy(adv),
                             attack=attack, attack_scale=2.0, noise_std=0.5)
    ctx = _ctx(m, active, draws={"byz": noise})
    state = {"params": {k: torch.from_numpy(v).to(tdt)
                        for k, v in pre_np.items()}}
    state = attacks.stage_snapshot(get_p)(state, ctx)
    post = {k: torch.from_numpy(v).to(tdt) for k, v in post_np.items()}
    got = attacks.stage_byzantine(ts, get_p, set_p)({"params": post}, ctx)
    assert "ow_pre" not in ctx.aux
    for k in pre_np:
        g = got["params"][k].float().numpy()
        w = np.asarray(want["params"][k], np.float32)
        np.testing.assert_array_equal(g, w, err_msg=k)
        np.testing.assert_array_equal(g[1:], post[k].float().numpy()[1:])
        assert not np.array_equal(g[0], post[k].float().numpy()[0])


def test_gaussian_noise_is_drawn_apart_and_reproducibly():
    """Without injection the noise comes from the round key's BYZ_SALT
    generator: the same round key draws the same noise, another round
    key other noise, and no strategy stream is read."""
    post = {"w": torch.zeros(4, 3), "v": torch.zeros(4, 2)}
    a = attacks.gaussian_noise(_ctx(4), post)
    b = attacks.gaussian_noise(_ctx(4), post)
    ctx = _ctx(4)
    ctx.key = (0, 1)
    c = attacks.gaussian_noise(ctx, post)
    assert sorted(a) == ["v", "w"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["w"], c["w"])


def test_byzantine_requires_an_attack():
    ts = attacks.ThreatState(adversaries=torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        attacks.stage_byzantine(ts, lambda s: s, lambda s, p: p)


# ---------------------------------------------------------------------------
# robust reducers vs the reference and numpy oracles
# ---------------------------------------------------------------------------

STAR = ["trimmed_mean", "median", "norm_clip"]


def _star(package, name, tree, active):
    mod = defense if package == "port" else ref_defense
    if name == "trimmed_mean":
        return mod.trimmed_mean_over_active(tree, active, trim=0.2)
    if name == "median":
        return mod.median_over_active(tree, active)
    return mod.norm_clip_mean_over_active(tree, active, clip=2.0)


@pytest.mark.parametrize("name", STAR)
def test_star_reducers_match_reference_for_every_active_count(name):
    """Every active count 0..M, with a planted outlier row and a second
    leaf: median bitwise as values, the others at rtol 1e-5; all-zero
    with no active row; against numpy for the order statistics."""
    m = 7
    rng = np.random.default_rng(2)
    x = rng.normal(size=(m, 5)).astype(np.float32)
    x[0] *= 1e3
    y = rng.normal(size=(m, 2, 3)).astype(np.float32)
    order = rng.permutation(m)
    for n in range(m + 1):
        active = np.zeros(m, bool)
        active[order[:n]] = True
        got = _star("port", name, {"x": torch.from_numpy(x),
                                   "y": torch.from_numpy(y)},
                    torch.from_numpy(active))
        want = _star("ref", name, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                     jnp.asarray(active))
        for k in ("x", "y"):
            g, w = got[k].numpy(), np.asarray(want[k])
            assert g.shape == w.shape
            if name == "median":
                np.testing.assert_array_equal(g, w, err_msg=f"{k} n={n}")
            else:
                _close(g, w)
            if n == 0:
                assert not g.any()
        if n and name != "norm_clip":
            s = np.sort(x[active], axis=0)
            if name == "median":
                want_np = np.median(x[active], axis=0)
            else:
                lo = min(int(np.floor(np.float32(0.2) * n)), (n - 1) // 2)
                want_np = s[lo:n - lo].mean(axis=0)
            _close(got["x"].numpy()[0], want_np)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_median_over_active_bitwise_in_bf16(dtype):
    m = 8
    rng = np.random.default_rng(9)
    x = rng.normal(size=(m, 33)).astype(np.float32)
    active = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    got = defense.median_over_active(
        {"x": torch.from_numpy(x).to(getattr(torch, dtype))},
        torch.from_numpy(active))["x"]
    want = ref_defense.median_over_active(
        {"x": jnp.asarray(x, getattr(jnp, dtype))}, jnp.asarray(active))["x"]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_client_norms_and_clip_scales_match_reference():
    m = 6
    rng = np.random.default_rng(3)
    tree = {"stages.0.0.conv1": rng.normal(size=(m, 3, 3)),
            "stages.1.0.conv1": rng.normal(size=(m, 2)),
            "stem.conv": rng.normal(size=(m, 4)) * 50.0}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    ref_tree = {"stages": [[{"conv1": jnp.asarray(tree["stages.0.0.conv1"])}],
                           [{"conv1": jnp.asarray(tree["stages.1.0.conv1"])}]],
                "stem": {"conv": jnp.asarray(tree["stem.conv"])}}
    port = {k: torch.from_numpy(v) for k, v in tree.items()}
    _close(defense.client_norms(port).numpy(),
           ref_defense.client_norms(ref_tree))
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    _close(defense.clip_scales(port, torch.from_numpy(mask),
                               clip=1.5).numpy(),
           ref_defense.clip_scales(ref_tree, jnp.asarray(mask), clip=1.5))


def test_norm_clip_shrinks_the_outlier():
    m = 6
    rng = np.random.default_rng(3)
    x = rng.normal(size=(m, 4)).astype(np.float32)
    x[0] *= 1e4
    got = defense.norm_clip_mean_over_active(
        {"w": torch.from_numpy(x)}, torch.ones(m, dtype=torch.bool),
        clip=2.0)["w"].numpy()
    assert np.linalg.norm(got[0]) < np.linalg.norm(x.mean(axis=0))
    assert np.isfinite(got).all()


@pytest.mark.parametrize("name", STAR)
@pytest.mark.parametrize("chunked", [False, True])
def test_robust_row_aggregate_matches_reference(monkeypatch, name,
                                                chunked):
    """Random peer sets (rows pulling 0..M−1 peers) and row-stochastic
    weights: median bitwise as values, the others at rtol 1e-5; column
    chunks of the peer axis give the same bits as one chunk."""
    m = 7
    rng = np.random.default_rng(5)
    x = rng.normal(size=(m, 10)).astype(np.float32)
    x[3] = 1e5
    y = rng.normal(size=(m, 3, 2)).astype(np.float32)
    edges = rng.uniform(size=(m, m)) < 0.5
    edges[np.arange(m), np.arange(m)] = False
    edges[5] = False                                # row 5 pulls nobody
    w = (edges | np.eye(m, dtype=bool)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    got = defense.robust_row_aggregate(
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        torch.from_numpy(edges), torch.from_numpy(w), m, defense=name,
        trim=0.2, clip=2.0)
    if chunked:
        monkeypatch.setattr(defense, "CHUNK_ELEMS", 2 * m * m)
        small = defense.robust_row_aggregate(
            {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
            torch.from_numpy(edges), torch.from_numpy(w), m, defense=name,
            trim=0.2, clip=2.0)
        for k in got:
            assert torch.equal(got[k], small[k]), k
    want = ref_defense.robust_row_aggregate(
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jnp.asarray(edges),
        jnp.asarray(w), m, defense=name, trim=0.2, clip=2.0)
    for k in ("x", "y"):
        if name == "median":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            _close(got[k].numpy(), want[k])
    if name != "norm_clip":
        np.testing.assert_array_equal(got["x"].numpy()[5], x[5])
    if name == "median":
        peers = edges[0] | (np.arange(m) == 0)
        _close(got["x"].numpy()[0], np.median(x[peers], axis=0))


def test_robust_row_aggregate_requires_a_defense():
    with pytest.raises(ValueError):
        defense.robust_row_aggregate({}, torch.zeros(3, 3, dtype=torch.bool),
                                     None, 3, defense="none")


def test_hooks_map_threat_configs():
    assert defense.star_reducer(None) is None
    assert defense.robust_mixer(ThreatConfig()) is None
    for name in STAR:
        t = ThreatConfig(defense=name)
        assert callable(defense.star_reducer(t))
        assert callable(defense.robust_mixer(t))


# ---------------------------------------------------------------------------
# isolation metrics
# ---------------------------------------------------------------------------

def _iso(edges, cand, adv, active, m):
    got = ow.isolation_metrics(
        torch.from_numpy(edges), None if cand is None else
        torch.from_numpy(cand), torch.from_numpy(adv),
        torch.from_numpy(active), m)
    want = ref_ow.isolation_metrics(
        jnp.asarray(edges), None if cand is None else jnp.asarray(cand),
        jnp.asarray(adv), jnp.asarray(active), m)
    for k in want:
        assert got[k].dtype == torch.float32
        assert float(got[k]) == float(want[k]), k
    return {k: float(v) for k, v in got.items()}


def test_isolation_metrics_extremes_match_reference():
    m = 6
    adv = np.array([False] * 4 + [True] * 2)
    active = np.ones(m, bool)
    shun = np.zeros((m, m), bool)
    shun[:4, :4] = ~np.eye(4, dtype=bool)
    got = _iso(shun, None, adv, active, m)
    assert got["adv_edge_frac"] == 0.0
    assert got["adv_isolation"] == pytest.approx(1.0)
    assert got["adv_base_frac"] == pytest.approx(2 / 5)
    prefer = np.zeros((m, m), bool)
    prefer[:4, 4:] = True
    got = _iso(prefer, None, adv, active, m)
    assert got["adv_edge_frac"] == 1.0 and got["adv_isolation"] < 0.0


def test_isolation_metrics_random_and_no_adversaries_match_reference():
    m = 9
    rng = np.random.default_rng(7)
    for _ in range(5):
        edges = rng.uniform(size=(m, m)) < 0.3
        cand = rng.uniform(size=(m, m)) < 0.8
        adv = rng.uniform(size=m) < 0.3
        active = rng.uniform(size=m) < 0.7
        _iso(edges & cand, cand, adv, active, m)
    got = _iso(np.ones((m, m), bool), None, np.zeros(m, bool),
               np.ones(m, bool), m)
    assert got["adv_isolation"] == 0.0


# ---------------------------------------------------------------------------
# lifecycle primitives, configs, composition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,init", [(4, None), (8, 0.5), (4, 0.0),
                                    (16, 0.99), (7, 0.3), (5, 1.0)])
def test_init_alive_matches_reference(m, init):
    churn = None if init is None else ChurnConfig(join_rate=0.1,
                                                  init_alive=init)
    rchurn = None if init is None else RefChurnConfig(join_rate=0.1,
                                                      init_alive=init)
    got = ow.init_alive(m, churn)
    np.testing.assert_array_equal(got, ref_ow.init_alive(m, rchurn))
    assert got.sum() >= 1


def test_threat_state_inert_forms():
    assert ow.threat_state(None, 6) is None
    assert ow.threat_state(ThreatConfig(), 6) is None
    assert ow.threat_state(ThreatConfig(adversary_fraction=0.5), 6) is None
    assert ow.threat_state(ThreatConfig(defense="median"), 6) is None
    ts = ow.threat_state(ThreatConfig(adversary_fraction=0.5,
                                      attack="sign_flip", seed=4), 6,
                         device="cpu")
    want = ref_ow.threat_state(RefThreatConfig(adversary_fraction=0.5,
                                               attack="sign_flip", seed=4), 6)
    np.testing.assert_array_equal(ts.adversaries.numpy(),
                                  np.asarray(want.adversaries))
    assert ts.attack == "sign_flip" and ts.adversaries.sum() == 3


@pytest.mark.parametrize("kw", [dict(attack="bogus"),
                                dict(score_game="bogus"),
                                dict(defense="bogus")])
def test_threat_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as got:
        ThreatConfig(**kw)
    with pytest.raises(ValueError) as want:
        RefThreatConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(), dict(adversary_fraction=0.3),
                                dict(adversary_fraction=0.3,
                                     attack="scale"),
                                dict(defense="median"),
                                dict(score_game="cost",
                                     adversary_fraction=0.1)])
def test_config_inert_properties_match_reference(kw):
    assert ThreatConfig(**kw).inert == RefThreatConfig(**kw).inert
    for ckw in (dict(), dict(join_rate=0.1), dict(init_alive=0.9),
                dict(leave_rate=0.2)):
        assert ChurnConfig(**ckw).inert == RefChurnConfig(**ckw).inert


@pytest.fixture(scope="module")
def cfgs():
    ref_cfg = dataclasses.replace(ref_get_config("resnet18-cifar").reduced(),
                                  dtype="float32", image_size=8)
    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=8)
    return ref_cfg, cfg


FL_KW = dict(num_clients=6, peers_per_round=2, client_sample_ratio=0.5,
             batch_size=4, epochs_extractor=1, epochs_header=1)


@pytest.mark.parametrize("name", ["pfeddst", "dfedavgm", "fedavg"])
def test_make_open_spec_returns_the_same_objects_when_inert(cfgs, name):
    """Absent configs, and present but inert ones: the StrategySpec a
    spec function built comes back as the very object, its init and stages
    untouched."""
    cfg = cfgs[1]
    build = (strategies._pfeddst_spec if name == "pfeddst" else
             strategies._gossip_spec if name == "dfedavgm" else
             strategies._central_spec)
    for fl in (FLConfig(**FL_KW),
               FLConfig(threat=ThreatConfig(), churn=ChurnConfig(),
                        **FL_KW),
               FLConfig(threat=ThreatConfig(adversary_fraction=0.5),
                        **FL_KW)):
        spec = build(cfg, fl, 1, name, torch.device("cpu"))
        init, stages = spec.init, spec.stages
        out = ow.make_open_spec(spec, fl)
        assert out is spec and out.init is init and out.stages is stages
    strat = strategies.make_strategy(
        name, cfg, FLConfig(threat=ThreatConfig(), churn=ChurnConfig(),
                            **FL_KW), 1, device="cpu")
    assert not any(stage_name(s).startswith("ow_") for s in strat.stages)
    assert not isinstance(strat.init(0), dict) or "inner" not in strat.init(0)


@pytest.mark.parametrize("name", ["pfeddst", "pfeddst_async", "dfedavgm",
                                  "fedavg", "fedbabu", "dispfl"])
@pytest.mark.parametrize("which", ["threat", "churn", "both"])
def test_wrapped_stage_order_matches_reference(cfgs, name, which):
    ref_cfg, cfg = cfgs
    tkw = dict(adversary_fraction=0.34, attack="sign_flip",
               score_game="both")
    ckw = dict(join_rate=0.2, leave_rate=0.1, init_alive=0.5)
    kw = {}
    rkw = {}
    if which in ("threat", "both"):
        kw["threat"], rkw["threat"] = (ThreatConfig(**tkw),
                                       RefThreatConfig(**tkw))
    if which in ("churn", "both"):
        kw["churn"], rkw["churn"] = ChurnConfig(**ckw), RefChurnConfig(**ckw)
    strat = strategies.make_strategy(name, cfg, FLConfig(**FL_KW, **kw), 1,
                                     device="cpu")
    spec = ref_make_spec(name, ref_cfg, RefFLConfig(**FL_KW, **rkw), 1)
    got = [stage_name(s) for s in strat.stages]
    assert got == [ref_stage_name(s) for s in spec.stages]
    if which != "churn":
        i = max(i for i, n in enumerate(got)
                if n in attacks.TRAIN_STAGE_NAMES)
        assert got[i + 1] == "ow_byzantine"
    state = strat.init(0)
    assert set(state) == {"inner", "alive"}
    assert int(state["alive"].sum()) == (3 if which != "threat" else 6)


def test_tree_paths_match_reference():
    """Nested dicts (keys sorted), lists, NamedTuples and None: the
    reference's paths in the reference's order."""
    from repro_torch.core.client_state import PopulationState

    rng = np.random.default_rng(0)

    def leaf(*shape):
        return rng.normal(size=shape).astype(np.float32)

    tree = {"z": {"b": leaf(2), "a": [leaf(1), leaf(3)]}, "a": leaf(2),
            "st": PopulationState(extractor={"w": leaf(2)},
                                  header={"h": leaf(1)}, opt_e=None,
                                  opt_h=None, loss_matrix=leaf(2, 2),
                                  last_selected=leaf(2, 2), round=leaf(),
                                  store=None)}
    got = [p for p, _ in tree_paths(tree)]
    from repro.core.client_state import PopulationState as RefPS
    rtree = {**tree, "st": RefPS(**tree["st"]._asdict())}
    assert got == [p for p, _ in ref_tree_paths(rtree)]
