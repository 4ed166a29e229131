"""PFedDST strategies — the `pfeddst` and `pfeddst_random` part of
reference `repro.fl.strategies`.

    init(seed)                      -> PopulationState
    round(state, data, key, draws)  -> (state, metrics)
    params_for_eval(state)          -> merged per-client params (leading M)

All local training uses the paper's §III-A recipe (SGD momentum 0.9,
weight decay 0.005, lr 0.1). The baselines and the semi-async variant are
ROADMAP queue 1 items 7 and 9 and raise here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.client_state import init_population
from repro_torch.core.partial_freeze import make_phase_steps
from repro_torch.core.rounds import PFEDDST_STREAMS, make_pfeddst_stages
from repro_torch.device import resolve_device
from repro_torch.fl.engine import run_round
from repro_torch.models.split import merge_params
from repro_torch.optim.sgd import sgd

STRATEGIES = ("pfeddst", "pfeddst_random")

NOT_PORTED = {
    "fedavg": 7, "fedper": 7, "fedbabu": 7, "dfedavgm": 7, "dispfl": 7,
    "dfedpgp": 7, "pfeddst_async": 9,
}


@dataclass
class Strategy:
    name: str
    init: Callable             # (seed) -> state
    round: Callable            # (state, data, key, draws=None) -> (state, metrics)
    params_for_eval: Callable  # (state) -> leading-M params


def make_strategy(name: str, cfg, fl, steps_per_epoch: int = 2, *,
                  device="cuda") -> Strategy:
    """The strategy `name` on `device` (default CUDA; raises without it)."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"strategy {name!r} is not ported yet (ROADMAP queue 1 item "
            f"{NOT_PORTED[name]})")
    if name not in STRATEGIES:
        raise KeyError(f"unknown strategy {name!r}; available: {STRATEGIES}")
    device = resolve_device(device)
    opt = sgd(fl.lr, momentum=fl.momentum, weight_decay=fl.weight_decay)
    if name == "pfeddst_random":
        fl = dataclasses.replace(fl, selection="random")
    stages = make_pfeddst_stages(
        cfg, fl, make_phase_steps(cfg, opt), steps_per_epoch=steps_per_epoch,
        probe_size=fl.probe_size, use_score_kernel=fl.use_score_kernel)

    def init(seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_population(cfg, gen, fl.num_clients, opt, opt, device)

    def round_fn(state, data, key, draws=None):
        return run_round(stages, state, data, key, m=fl.num_clients,
                         ratio=fl.client_sample_ratio,
                         key_streams=PFEDDST_STREAMS, draws=draws)

    return Strategy(name=name, init=init, round=round_fn,
                    params_for_eval=lambda s: merge_params(s.extractor,
                                                           s.header))
