"""The reference against the port at a tiny size on the CPU, a run with
the timed path broken underneath coming out not correct for each fault a
cell can have, and the control (the reference in fp8 in the program's
place) failing the cell's limits."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from gpubench import readings
from gpubench.checks import tiny
from gpubench.harness.program import Port, flat
from gpubench.reference import fl as ref_fl

CELLS = ("qwen2-pfeddst", "cifar-pfeddst")


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_in_float32(name):
    res = tiny.run(name)
    assert res["correct"], res["checked"]
    for row in res["checked"].values():
        assert row["value"] <= 1e-4
    assert res["failed"] == 0 and res["attempted"] >= 1


# ---- the timed path broken underneath --------------------------------------

class Frozen(Port):
    """A round that returns its state unchanged (parameters, momenta)."""

    def round(self, state, data, key, draws, round_fn=None):
        views = (self.params, self.momenta)
        before = [{k: t.clone() for k, t in v(state).items()} for v in views]
        state, metrics, scalars = super().round(state, data, key, draws,
                                                round_fn)
        for v, saved in zip(views, before):
            for k, t in v(state).items():
                t.copy_(saved[k])
        return state, metrics, scalars


class HalfClients(Port):
    """Half of the round's sampled clients left out: their parameters and
    momenta come back as they were."""

    def round(self, state, data, key, draws, round_fn=None):
        rows = draws["act"][:max(1, len(draws["act"]) // 2)].tolist()
        views = (self.params, self.momenta)
        before = [{k: t[rows].clone() for k, t in v(state).items()}
                  for v in views]
        state, metrics, scalars = super().round(state, data, key, draws,
                                                round_fn)
        for v, saved in zip(views, before):
            for k, t in v(state).items():
                t[rows] = saved[k]
        return state, metrics, scalars


def _replace_stages(port, swap):
    from repro_torch.fl.engine import make_round
    from repro_torch.obs.timers import stage_name

    stages = []
    for s in port.strat.spec.stages:
        stages += swap(stage_name(s), s)
    port.strat.spec = dataclasses.replace(port.strat.spec,
                                          stages=tuple(stages))
    port.strat.round = make_round(port.strat.spec, port.fl,
                                  port.strat.fabric)


class NoAggregation(Port):
    """The exchange between clients left out."""

    def __init__(self, *a):
        super().__init__(*a)

        def keep(state, ctx):
            if hasattr(state, "extractor"):
                ctx.aux["agg_e"] = state.extractor
            return state

        _replace_stages(self, lambda n, s: [keep] if n in (
            "aggregate",) else [s])


class Altered(Port):
    """An answer altered where it is produced: the first Eq. 6 row summed
    over its probe rows instead of averaged."""

    def round(self, state, data, key, draws, round_fn=None):
        from repro_torch.core import rounds

        real, probe = rounds.loss_disparity_rows, self.fl.probe_size

        def summed(*a, **kw):
            out = real(*a, **kw).clone()
            out[0] *= probe
            return out

        rounds.loss_disparity_rows = summed
        try:
            return super().round(state, data, key, draws, round_fn)
        finally:
            rounds.loss_disparity_rows = real


class HalfBatch(Port):
    """Half of every SGD step's batch left out, the mean taken over the
    rest."""

    def round(self, state, data, key, draws, round_fn=None):
        from repro_torch.core import partial_freeze

        real = partial_freeze._grads

        def half(cfg, trained, frozen, batch, *a, **kw):
            b = next(iter(batch.values())).shape[0] // 2
            return real(cfg, trained, frozen,
                        {k: v[:b] for k, v in batch.items()}, *a, **kw)

        partial_freeze._grads = half
        try:
            return super().round(state, data, key, draws, round_fn)
        finally:
            partial_freeze._grads = real


class BottomK(Port):
    """The selection altered where it is produced: each row's k
    lowest-scoring peers by Eq. 9, and the aggregation over them."""

    def __init__(self, *a):
        super().__init__(*a)
        from repro_torch.core.aggregation import selection_to_weights
        from repro_torch.fl.engine import ExchangePlan

        fl = self.fl

        def bottom(state, ctx):
            m = ctx.m
            x = torch.cat([t.reshape(m, -1).float()
                           for t in flat(state.header).values()], 1)
            inv = 1.0 / (x.square().sum(1).sqrt() + 1e-12)
            s_d = ((x @ x.T) * inv[:, None] * inv[None, :]).clamp(-1, 1)
            last = state.last_selected
            dt = (int(state.round) - last).clamp_min(0).float()
            s_p = torch.where(last < 0, 1.0,
                              1.0 - torch.exp(-fl.recency_lambda * dt))
            scores = s_p * (fl.alpha * ctx.aux["s_l"] - s_d + fl.comm_cost)
            k = min(fl.peers_per_round, m - 1)
            mask = ref_fl.bottom_k_mask(scores, k) & ctx.active[:, None]
            ctx.plan = ExchangePlan(
                "p2p", active=ctx.active, edges=mask,
                weights=selection_to_weights(mask, include_self=True))
            return state

        _replace_stages(self, lambda n, s: [s, bottom]
                        if n == "score_select" else [s])


# the faults a PFedDST cell can have, planted in the timed path
FAULTS = {"frozen": Frozen, "half_clients": HalfClients,
          "half_batch": HalfBatch, "no_aggregation": NoAggregation,
          "altered": Altered, "bottom_k": BottomK}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault):
    res = tiny.run(name, program=FAULTS[fault])
    assert not res["correct"], res["checked"]


@pytest.mark.parametrize("name", ("qwen2-pfeddst", "cifar-pfeddst"))
def test_control_fails_the_limits(name):
    """The reference in fp8 in the program's place, against the float32
    reference, at a tiny size in bfloat16."""
    cell = tiny.cell(name)
    model = tiny.model(cell["config"], "bfloat16", cnn_depth=(2, 2, 2, 2))
    (variant, gaps, _, _), = readings.readings(
        cell, model, 11, ["control"], torch.device("cpu"))
    assert any(gaps[n] > limit for n, limit in cell["limits"].items()), gaps
