"""Churn rounds of the port against live rounds of the JAX reference, by
the runner of tests/test_torch_openworld_round.py (the reference's leave
and join uniforms injected as `draws["churn"]`; M = 6, the reduced ResNet
in f32 at width 32, 3 rounds; the same exact and rtol-2e-3 comparisons):
churn on pfeddst, on dispfl (mask flips only next to a threshold, at most
8) and on pfeddst_async (the newcomer bootstraps from the served store
view). Port-level: the zero-alive guard against the reference's stage,
and a joined row's bootstrap and resets.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.engine import RoundContext as RefRoundContext
from repro.openworld import lifecycle as ref_lifecycle
from repro_torch.configs import ChurnConfig
from repro_torch.fl import engine, strategies
from repro_torch.openworld import lifecycle

from test_torch_openworld_round import (  # noqa: F401 (setup: a fixture)
    CHURN,
    M,
    _configs,
    _run,
    setup,
)


@pytest.mark.parametrize("name", ["pfeddst", "dispfl", "pfeddst_async"])
def test_churn_rounds_match_reference(setup, name):
    fl, rfl = _configs(churn=CHURN)
    flips = _run(setup, name, fl, rfl, rounds=3)
    assert flips <= 8, flips


def ref_round_context():
    return RefRoundContext(m=M, data={}, keys={"act": jax.random.PRNGKey(0)},
                           active=jnp.ones((M,), bool),
                           sampled_idx=jnp.arange(M))


def test_zero_alive_guard_rolls_the_churn_back(setup):
    """leave_rate 1 empties the population: the round keeps the previous
    alive mask (no one joined or left, nobody inactive for it), as the
    reference does on the same inputs."""
    cfg, train = setup[1], setup[4]
    fl, rfl = _configs(churn=dict(leave_rate=1.0, join_rate=0.0,
                                  init_alive=0.5))
    strat = strategies.make_strategy("fedavg", cfg, fl, 1, device="cpu")
    state = strat.init(0)
    alive0 = state["alive"].clone()
    state, met = strat.round(state, train, (0, 0))
    assert torch.equal(state["alive"], alive0)
    assert int(met["left_n"]) == 0 and int(met["joined_n"]) == 0
    assert float(met["alive_frac"]) == 0.5
    assert not (met["active"] & ~alive0).any()
    # the reference's stage on the same membership
    rctx = dataclasses.replace(
        ref_round_context(), active=jnp.ones((M,), bool))
    rout = ref_lifecycle.stage_churn(rfl.churn)(
        {"inner": {"params": {"w": jnp.zeros((M, 2))}},
         "alive": jnp.asarray(alive0.numpy())}, rctx)
    np.testing.assert_array_equal(np.asarray(rout["alive"]), alive0.numpy())


def test_joined_rows_bootstrap_and_reset(setup):
    """A joined slot's parameters are the mean over the pre-churn alive
    rows; its optimizer rows are 0, loss row 0, recency row −1; the other
    rows pass through bit for bit."""
    cfg, train = setup[1], setup[4]
    fl, _ = _configs(churn=dict(init_alive=0.5))
    strat = strategies.make_strategy("pfeddst", cfg, fl, 1, device="cpu")
    state = strat.round(strat.init(0), train, (0, 0))[0]
    alive = state["alive"].clone()
    inner = state["inner"]
    ctx = engine.RoundContext(m=M, data={}, streams={},
                              active=torch.ones(M, dtype=torch.bool),
                              sampled_idx=torch.arange(M), key=(0, 1),
                              draws={"churn": (np.ones(M), np.zeros(M))})
    out = lifecycle.stage_churn(ChurnConfig(join_rate=1.0))(
        {"inner": inner, "alive": alive}, ctx)
    joined = ~alive
    assert joined.any() and out["alive"].all()
    boot = lifecycle._mean_over_active(
        {"e": inner.extractor, "h": inner.header}, alive)
    new = out["inner"]
    for part, tree in (("e", new.extractor), ("h", new.header)):
        old = inner.extractor if part == "e" else inner.header
        for n, t in tree.items():
            assert torch.equal(t[joined], boot[part][n][joined]), n
            assert torch.equal(t[~joined], old[n][~joined]), n
    for n, t in new.opt_e["mu"].items():
        assert not t[joined].any() and torch.equal(
            t[~joined], inner.opt_e["mu"][n][~joined])
    assert not new.loss_matrix[joined].any()
    assert (new.last_selected[joined] == -1).all()
    assert torch.equal(new.last_selected[~joined],
                       inner.last_selected[~joined])
    assert (ctx.cand == (~torch.eye(M, dtype=torch.bool))).all()
