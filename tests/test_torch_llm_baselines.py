"""The baselines' federated LLM rounds in the port against the JAX
reference: two rounds each of fedavg, dfedavgm, dfedpgp and dispfl over
reduced qwen2-1.5b in float32 (M = 4, every client sampled, client 2
offline), with the reference's draws injected and both packages starting
from the reference's init. The port's LLM population trains, mixes and
masks in place (`fl.engine.trains_in_place`); dfedpgp takes the card's
route, the packed plan mixed in column blocks. Each strategy's first
round is also taken by the functional route, which must equal the
in-place one bit for bit.

The reference's rounds are jitted at XLA's lowest optimisation level,
all started at once on threads, to keep the file quick.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as RefFLConfig
from repro.fl.engine import run_round as ref_run_round
from repro.fl.strategies import make_spec as ref_make_spec
from repro_torch import convert
from repro_torch.configs import FLConfig
from repro_torch.fl import engine, strategies
from repro_torch.fl.engine import run_round
from repro_torch.kernels import ops

from test_torch_baselines import _mask_flips, reference_baseline_draws
from test_torch_llm_round import (BATCH, K, LR, M, N_LOCAL, ONLINE, SEQ,
                                  _cfgs, _close_trees, _compile,
                                  _equal_trees, _functional, _tokens)
from test_torch_llm_round import _one_thread  # noqa: F401 (autouse)
from test_torch_support import to_numpy

# peers per round (dfedpgp's k = 1 packs its plan, D = 2 ≤ M / 2, as on
# the card)
BASELINE_PEERS = {"fedavg": K, "dfedavgm": K, "dfedpgp": 1, "dispfl": K}
BASELINE_ROUNDS = 2


def _baseline_setup(name):
    """BASELINE_ROUNDS reference rounds of `name` over reduced qwen2 with
    client 2 offline, from the reference's own init (dispfl's masks
    included): each round's draws, new state and metrics (dispfl's
    parameters before the mask evolution too)."""
    rcfg, cfg = _cfgs("qwen2-1.5b")
    kw = dict(num_clients=M, peers_per_round=BASELINE_PEERS[name],
              batch_size=BATCH, client_sample_ratio=1.0, epochs_extractor=1,
              epochs_header=1, lr=LR)
    rfl, fl = RefFLConfig(comms=None, **kw), FLConfig(**kw)
    spec = ref_make_spec(name, rcfg, rfl, steps_per_epoch=1)
    state = spec.init(jax.random.PRNGKey(1))
    init = to_numpy(state)
    tokens = _tokens(cfg, (M, N_LOCAL, SEQ), seed=8)
    data, avail = {"tokens": jnp.asarray(tokens)}, jnp.asarray(ONLINE)

    def fn(stages):
        return lambda st, k: ref_run_round(
            stages, st, data, k, m=M, ratio=1.0,
            key_streams=spec.key_streams, available=avail)

    split = name == "dispfl"     # read the parameters the masks evolve from
    parts = (spec.stages[:-2], spec.stages[-2:]) if split else (spec.stages,)
    key0 = jax.random.PRNGKey(5)
    fns = [_compile(fn(stages), state, key0) for stages in parts]
    out = []
    for r in range(BASELINE_ROUNDS):
        key = jax.random.fold_in(key0, r)
        draws = reference_baseline_draws(
            key, spec.key_streams, state["params"], n_local=N_LOCAL,
            n_steps=1, regrow=rfl.dispfl_regrow, m=M, ratio=1.0,
            batch_size=BATCH, family=cfg.family)
        state, met = fns[0](state, key)
        pre = to_numpy(state["params"]) if split else None
        if split:
            state, _ = fns[1](state, key)
        out.append(dict(draws=draws, state=to_numpy(state),
                        met=to_numpy(met), pre=pre))
    return dict(cfg=cfg, fl=fl, init=init, tokens=tokens, rounds=out,
                keep=1 - rfl.dispfl_sparsity)


@pytest.mark.parametrize("name", list(BASELINE_PEERS))
def test_llm_baseline_rounds_match_reference(name, monkeypatch, capsys):
    """Two rounds of a baseline over reduced qwen2 (M = 4, every client
    sampled, client 2 offline), the reference's draws injected, from the
    reference's init: `active` and `comm_edges` exact; dispfl's masks
    exact save entries within 2e-3 of their leaf's threshold (left out
    of the comparison; the port is then re-seeded); parameters and
    momenta within TOL of the scale; `train_loss` within 1e-5. dfedpgp
    mixes through the packed plan in 4096-column blocks (the card's
    route). The first round taken functionally equals the in-place one
    bit for bit. The per-round losses are printed."""
    job = _jobs()[name].result()
    cfg, fl = job["cfg"], job["fl"]
    if name == "dfedpgp":
        monkeypatch.setattr(ops, "MIN_PACKED_MIX_CPU", 1)
        monkeypatch.setattr(engine, "F32_BLOCK_COLUMNS", 4096)
    data = {"tokens": torch.from_numpy(job["tokens"])}

    def start(state_np):
        return convert.baseline_state_from_reference(state_np, device="cpu",
                                                     family=cfg.family)

    def round_fn(state, r, stages):
        return run_round(stages, state, data, (0, r), m=M, ratio=1.0,
                         key_streams=spec.key_streams,
                         draws=job["rounds"][r]["draws"], available=ONLINE)

    spec = strategies.make_spec(name, cfg, fl, steps_per_epoch=1,
                                device="cpu")
    state, flips, losses = start(job["init"]), 0, []
    for r, want in enumerate(job["rounds"]):
        state, met = round_fn(state, r, spec.stages)
        rmet, rstate = want["met"], want["state"]
        if r == 0:      # the next round writes into this state
            first = engine.tree_map(torch.clone, (state, met))
        np.testing.assert_array_equal(met["active"].numpy(), ONLINE)
        np.testing.assert_array_equal(met["active"].numpy(), rmet["active"])
        if "comm_edges" in rmet:
            np.testing.assert_array_equal(met["comm_edges"].numpy(),
                                          rmet["comm_edges"])
        got = convert.baseline_state_to_reference(state, family=cfg.family)
        assert int(got["round"]) == int(rstate["round"]) == r + 1
        skip = None
        if name == "dispfl":
            skip = _mask_flips(got["mask"], rstate["mask"], want["pre"],
                               job["keep"])
            flips += sum(int(f.sum())
                         for f in jax.tree_util.tree_leaves(skip))
        _close_trees(got["params"], rstate["params"], "params", skip=skip)
        _close_trees(got["opt"]["mu"], rstate["opt"]["mu"], "opt mu")
        np.testing.assert_array_equal(got["opt"]["count"],
                                      rstate["opt"]["count"])
        np.testing.assert_allclose(float(met["train_loss"]),
                                   float(rmet["train_loss"]), rtol=1e-5)
        losses.append((float(met["train_loss"]), float(rmet["train_loss"])))
        if skip is not None and any(f.any() for f in
                                    jax.tree_util.tree_leaves(skip)):
            state = start(rstate)
    assert flips <= 8, flips
    _functional(monkeypatch)
    fspec = strategies.make_spec(name, cfg, fl, steps_per_epoch=1,
                                 device="cpu")
    fnew, fmet = round_fn(start(job["init"]), 0, fspec.stages)
    with capsys.disabled():
        print(f"\n{name} train_loss by round (port, reference): {losses}")
    _equal_trees(fnew, first[0], "functional state")
    _equal_trees(fmet, first[1], "functional metrics")


@functools.lru_cache(maxsize=None)
def _jobs():
    """The reference's rounds of every baseline, started at once on
    threads."""
    pool = ThreadPoolExecutor(len(BASELINE_PEERS))
    jobs = {n: pool.submit(_baseline_setup, n) for n in BASELINE_PEERS}
    pool.shutdown(wait=False)
    return jobs
