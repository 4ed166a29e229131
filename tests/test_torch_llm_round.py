"""Federated LLM training in the port against the JAX reference, at
reduced configs in float32: PFedDST rounds over reduced qwen2-1.5b with
the reference's draws injected (the population trains in place), every
client sampled and then one of them offline, each also against the
functional round, bit for bit (the baselines' LLM rounds are in
tests/test_torch_llm_baselines.py); the MoE's Eq. 6 matrix (one forward a probe batch), `launch.steps`'
`make_train_pair_step` and `make_fed_round_step`, the column-blocked
gossip mix, the LLM population's conversion, and one-round runs of
`launch.train --reduced` and the `federated_llm` twin. Also the repaired
entry point: `openworld.make_open_spec` without a device asks for the
card.

The reference's calls are jitted at XLA's lowest optimisation level
(`run_jit`), on a few threads, to keep the file quick.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import FLConfig as RefFLConfig
from repro.core.client_state import PopulationState as RefPopulationState
from repro.core.partial_freeze import make_phase_steps as ref_phase_steps
from repro.core.rounds import PFEDDST_STREAMS as REF_STREAMS
from repro.core.rounds import make_pfeddst_stages as ref_stages
from repro.core.scoring import header_gram_tree as ref_gram_tree
from repro.core.scoring import loss_disparity_rows as ref_eq6
from repro.fl.engine import run_round as ref_run_round
from repro.launch.steps import make_fed_round_step as ref_fed_round
from repro.launch.steps import make_train_pair_step as ref_pair_step
from repro.optim.sgd import sgd as ref_sgd
from repro_torch import convert
from repro_torch import openworld as ow
from repro_torch.configs import ChurnConfig, FLConfig, ThreatConfig
from repro_torch.configs import get_config
from repro_torch.core.client_state import init_population
from repro_torch.core.partial_freeze import make_phase_steps
from repro_torch.core import rounds
from repro_torch.core.rounds import PFEDDST_STREAMS, make_pfeddst_stages
from repro_torch.core.scoring import (flatten_headers, header_gram_tree,
                                      loss_disparity_rows)
from repro_torch.data.synthetic import synth_tokens
from repro_torch.fl import engine, strategies
from repro_torch.fl.engine import ExchangePlan, mix_tree, run_round
from repro_torch.kernels.gossip_mix import weights_to_neighbors
from repro_torch.kernels.ref import select_score_ref
from repro_torch.launch.steps import (make_fed_round_step,
                                      make_train_pair_step)
from repro_torch.models import model
from repro_torch.models.layers import per_example_nll
from repro_torch.models.split import split_params
from repro_torch.optim.adam import adamw
from repro_torch.optim.sgd import sgd
from repro_torch.utils.pytree import tree_paths

from test_torch_support import close_to_scale, reference_draws, to_numpy

M, K, PROBE, BATCH, SEQ, N_LOCAL = 4, 2, 4, 8, 16, 10
LR, MOM, WD = 0.05, 0.9, 0.005
TOL = 1e-4          # parameters and momenta, of each leaf's scale
# client 2 is sampled but offline: it trains on copies that are dropped
ONLINE = np.array([True, True, False, True])
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: as fast for these small tensors, parallel test
    workers do not oversubscribe the cores, and the CPU's embedding
    backward (a parallel index_add) sums in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_jit(fn, *args):
    """fn(*args) jitted, compiled at XLA's lowest optimisation level."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def _cfgs(arch):
    return (dataclasses.replace(ref_get_config(arch).reduced(),
                                dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close_trees(got, want, what, tol=TOL, skip=None):
    """Each leaf within `tol` of its scale; entries where `skip` (a tree
    of bool arrays) is set are left out."""
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    sk = (jax.tree_util.tree_leaves(skip) if skip is not None
          else [None] * len(g))
    assert len(g) == len(w) == len(sk), what
    for a, b, f in zip(g, w, sk):
        a, b = np.asarray(a), np.asarray(b)
        if f is not None:
            a, b = a[~f], b[~f]
        close_to_scale(a, b, tol, what)


def _equal_trees(got, want, what):
    """Bit for bit, leaf by leaf (named as `tree_paths` names them)."""
    g, w = tree_paths(got), tree_paths(want)
    assert [n for n, _ in g] == [n for n, _ in w], what
    bad = [(n, float((a.float() - b.float()).abs().max()))
           for (n, a), (_, b) in zip(g, w) if not torch.equal(a, b)]
    assert not bad, (what, bad)


def _compile(fn, *args):
    """fn jitted and compiled for `args`' shapes at XLA's lowest
    optimisation level."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)


def _functional(monkeypatch):
    """Stages built from here on take the functional route."""
    for mod in (engine, rounds, strategies):
        monkeypatch.setattr(mod, "trains_in_place", lambda cfg: False)


def _ref_population(state, family):
    """The port's population as the reference's PopulationState."""
    d = convert.population_to_reference(state, family=family)
    d.pop("store")
    return RefPopulationState(**jax.tree_util.tree_map(jnp.asarray, d))


def _round_setup(available=None):
    """The reference's PFedDST round over reduced qwen2 from the port's
    initial population (`available`: the round's online mask)."""
    rcfg, cfg = _cfgs("qwen2-1.5b")
    kw = dict(num_clients=M, peers_per_round=K, batch_size=BATCH,
              client_sample_ratio=1.0, epochs_extractor=1, epochs_header=1,
              probe_size=PROBE, lr=LR)
    rfl, fl = RefFLConfig(comms=None, **kw), FLConfig(**kw)
    opt = sgd(LR, momentum=fl.momentum, weight_decay=fl.weight_decay)
    state = init_population(cfg, torch.Generator().manual_seed(0), M, opt,
                            opt, "cpu")
    rstate = _ref_population(state, cfg.family)
    tokens = _tokens(cfg, (M, N_LOCAL, SEQ))
    ropt = ref_sgd(LR, momentum=rfl.momentum, weight_decay=rfl.weight_decay)
    rstages = ref_stages(rcfg, rfl, ref_phase_steps(rcfg, ropt),
                         steps_per_epoch=1, probe_size=PROBE)
    key = jax.random.PRNGKey(3)
    avail = None if available is None else jnp.asarray(available)
    want = run_jit(lambda st, k: ref_run_round(
        rstages, st, {"tokens": jnp.asarray(tokens)}, k, m=M, ratio=1.0,
        key_streams=REF_STREAMS, available=avail), rstate, key)
    return dict(cfg=cfg, fl=fl, opt=opt, state=state, tokens=tokens,
                key=key, want=want, available=available)


def _check_pfeddst_round(job, monkeypatch):
    """The port's round from the job's state against the reference's: the
    selection mask and recency exact (the Eq. 9 margin asserted), the
    loss matrix, parameters and momenta within tolerance; then the
    functional round from the same state, bit for bit the in-place one."""
    cfg, fl, opt = job["cfg"], job["fl"], job["opt"]
    rnew, rmet = job["want"]
    draws = reference_draws(job["key"], m=M, ratio=1.0, n_local=N_LOCAL,
                            probe_size=PROBE, batch_size=BATCH, n_e=1,
                            n_h=1)
    state = job["state"]
    before = type(state)(*(engine.tree_map(torch.clone, f) for f in state))
    data = {"tokens": torch.from_numpy(job["tokens"])}
    kw = dict(m=M, ratio=1.0, key_streams=PFEDDST_STREAMS, draws=draws,
              available=job["available"])
    stages = make_pfeddst_stages(cfg, fl, make_phase_steps(cfg, opt),
                                 steps_per_epoch=1, probe_size=PROBE)
    new, met = run_round(stages, state, data, (0, 0), **kw)
    s, _ = select_score_ref(flatten_headers(before.header),
                            before.last_selected, new.loss_matrix,
                            before.round, fl.comm_cost, alpha=fl.alpha,
                            lam=fl.recency_lambda)
    srt = torch.sort(s, dim=1, descending=True).values
    margin = float((srt[:, K - 1] - srt[:, K]).min())
    assert margin > 1e-4, f"near-tied Eq. 9 scores ({margin})"
    np.testing.assert_array_equal(met["active"].numpy(),
                                  np.asarray(rmet["active"]))
    np.testing.assert_array_equal(met["select_mask"].numpy(),
                                  np.asarray(rmet["select_mask"]))
    got = convert.population_to_reference(new, family=cfg.family)
    np.testing.assert_array_equal(got["last_selected"],
                                  np.asarray(rnew.last_selected))
    close_to_scale(got["loss_matrix"], np.asarray(rnew.loss_matrix), 1e-5,
                   "loss_matrix")
    for field in ("extractor", "header"):
        _close_trees(got[field], getattr(rnew, field), field)
    for field in ("opt_e", "opt_h"):
        _close_trees(got[field]["mu"], getattr(rnew, field)["mu"], field)
    for k in ("train_loss_e", "train_loss_h", "s_l_mean"):
        np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                   rtol=1e-5, err_msg=k)
    _functional(monkeypatch)
    stages = make_pfeddst_stages(cfg, fl, make_phase_steps(cfg, opt),
                                 steps_per_epoch=1, probe_size=PROBE)
    fnew, fmet = run_round(stages, before, data, (0, 0), **kw)
    _equal_trees(fnew, new, "functional state")
    _equal_trees(fmet, met, "functional metrics")


def test_pfeddst_round_on_reduced_qwen2_matches_reference(monkeypatch):
    """One PFedDST round, M = 4, k = 2, every client sampled, the
    reference's draws injected: the selection mask and recency exact
    (the Eq. 9 margin asserted), the loss matrix, parameters and momenta
    within tolerance. The port's LLM population trains in place, and
    equals the functional round bit for bit."""
    _check_pfeddst_round(_jobs()["round"].result(), monkeypatch)


def test_pfeddst_round_with_an_offline_client_matches_reference(
        monkeypatch):
    """As above with client 2 sampled but offline (the `available` mask):
    its rows keep their values while it trains on dropped copies, and
    the aggregate keeps its own extractor."""
    _check_pfeddst_round(_jobs()["round_offline"].result(), monkeypatch)


def _eq6_setup():
    rcfg, cfg = _cfgs("phi3.5-moe-42b-a6.6b")
    m = 3
    params = init_population(cfg, torch.Generator().manual_seed(1), m,
                             sgd(LR), sgd(LR), "cpu")
    full = {**params.extractor, **params.header}
    probes = {"tokens": _tokens(cfg, (m, 2, 12), seed=1)}
    rfull = convert.params_to_reference(full, family=cfg.family)
    want = run_jit(lambda p, b: ref_eq6(rcfg, p, b), rfull, probes)
    return dict(cfg=cfg, m=m, full=full, probes=probes, want=want)


def test_moe_eq6_matrix_matches_reference():
    """Eq. 6 for phi3.5-moe: the MoE's capacity and drops depend on the
    tokens of a call, so the port evaluates each probe batch alone, as
    the reference's vmap does; the (M, M) matrix within 1e-5, and a
    forward of all probes at once would give another."""
    job = _jobs()["eq6"].result()
    cfg, m, full = job["cfg"], job["m"], job["full"]
    tprobes = {"tokens": torch.from_numpy(job["probes"]["tokens"])}
    got = loss_disparity_rows(cfg, full, tprobes)
    close_to_scale(got.numpy(), np.asarray(job["want"]), 1e-5, "Eq. 6")
    # client 0's row by one forward of all M probes: other capacities
    flat = {"tokens": tprobes["tokens"].reshape(m * 2, 12)}
    logits, _ = model.forward(cfg, engine.client_rows(full, 0), flat)
    nll = per_example_nll(logits[:, :-1], flat["tokens"][:, 1:])
    assert float((nll.reshape(m, -1).mean(1) - got[0]).abs().max()) > 1e-6


def _pair_setup():
    rcfg, cfg = _cfgs("phi3.5-moe-42b-a6.6b")
    params = model.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    e, h = split_params(cfg, params)
    batch = {"tokens": _tokens(cfg, (2, 12), seed=2)}
    ropt = ref_sgd(LR, momentum=MOM, weight_decay=WD)
    rstep = ref_pair_step(rcfg, ropt, ropt)
    re, rh = (convert.params_to_reference(t, family=cfg.family)
              for t in (e, h))
    want = run_jit(lambda a, b, bt: rstep(a, b, ropt.init(a), ropt.init(b),
                                          bt), re, rh, batch)
    return dict(cfg=cfg, e=e, h=h, batch=batch, want=want)


def test_make_train_pair_step_matches_reference():
    """`launch.steps.make_train_pair_step` (backend "chunked", remat) on
    reduced phi3.5-moe: phase e, then phase h on the new extractor;
    parameters, momenta and both losses."""
    job = _jobs()["pair"].result()
    cfg, e, h, want = job["cfg"], job["e"], job["h"], job["want"]
    opt = sgd(LR, momentum=MOM, weight_decay=WD)
    got = make_train_pair_step(cfg, opt, opt)(
        e, h, opt.init(e), opt.init(h),
        {"tokens": torch.from_numpy(job["batch"]["tokens"])})
    for i, what in ((0, "extractor"), (1, "header")):
        _close_trees(convert.params_to_reference(got[i], family=cfg.family),
                     want[i], what)
    for i, what in ((2, "opt_e"), (3, "opt_h")):
        _close_trees(convert.params_to_reference(got[i]["mu"],
                                                 family=cfg.family),
                     want[i]["mu"], what)
    for k in ("loss_e", "loss_h"):
        np.testing.assert_allclose(float(got[4][k]), float(want[4][k]),
                                   rtol=1e-5, err_msg=k)


def _fed_setup():
    rcfg, cfg = _cfgs("qwen2-1.5b")
    m = 3
    fl = FLConfig(num_clients=m, peers_per_round=1, lr=LR)
    rfl = RefFLConfig(num_clients=m, peers_per_round=1, lr=LR, comms=None)
    opt = sgd(LR, momentum=fl.momentum, weight_decay=fl.weight_decay)
    state = init_population(cfg, torch.Generator().manual_seed(4), m, opt,
                            opt, "cpu")
    last = torch.full((m, m), -1, dtype=torch.int32)
    probe = {"tokens": _tokens(cfg, (m, 2, 12), seed=4)}
    train = {"tokens": _tokens(cfg, (m, 2, 12), seed=5)}
    ref = convert.population_to_reference(state, family=cfg.family)
    ropt = ref_sgd(LR, momentum=rfl.momentum, weight_decay=rfl.weight_decay)
    rstep = ref_fed_round(rcfg, rfl, ropt, ropt)
    want = run_jit(rstep, ref["extractor"], ref["header"], ref["opt_e"],
                   ref["opt_h"], np.asarray(last), np.int32(0), probe, train)
    gram = run_jit(ref_gram_tree, ref["header"])
    return dict(cfg=cfg, fl=fl, opt=opt, state=state, last=last,
                probe=probe, train=train, want=want, gram=gram)


def test_make_fed_round_step_matches_reference():
    """`launch.steps.make_fed_round_step` on reduced qwen2 (M = 3): Eq. 6
    over every client, Eq. 7 by `header_gram_tree`, the top-k, then one
    phase-e and one phase-h step a client; recency exact, parameters and
    momenta within tolerance."""
    job = _jobs()["fed"].result()
    cfg, fl, opt, state, want = (job[k] for k in ("cfg", "fl", "opt",
                                                  "state", "want"))
    np.testing.assert_allclose(header_gram_tree(state.header).numpy(),
                               np.asarray(job["gram"]), rtol=1e-5,
                               atol=1e-6)
    got = make_fed_round_step(cfg, fl, opt, opt)(
        state.extractor, state.header, state.opt_e, state.opt_h,
        job["last"], torch.zeros((), dtype=torch.int32),
        {"tokens": torch.from_numpy(job["probe"]["tokens"])},
        {"tokens": torch.from_numpy(job["train"]["tokens"])})
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert int(got[5]) == int(want[5]) == 1
    for i, what in ((0, "extractor"), (1, "header")):
        _close_trees(convert.params_to_reference(got[i], family=cfg.family),
                     want[i], what)
    for i, what in ((2, "opt_e"), (3, "opt_h")):
        _close_trees(convert.params_to_reference(got[i]["mu"],
                                                 family=cfg.family),
                     want[i]["mu"], what)
    for k in ("loss_e", "loss_h", "mean_score"):
        np.testing.assert_allclose(float(got[6][k]), float(want[6][k]),
                                   rtol=1e-5, err_msg=k)


@functools.lru_cache(maxsize=None)
def _jobs():
    """The reference's computations, started at once on threads:
    tracing one while XLA compiles another keeps the file quick."""
    pool = ThreadPoolExecutor(4)
    jobs = {name: pool.submit(fn) for name, fn in (
        ("round", _round_setup),
        ("round_offline", functools.partial(_round_setup, ONLINE)),
        ("fed", _fed_setup), ("pair", _pair_setup), ("eq6", _eq6_setup))}
    pool.shutdown(wait=False)
    return jobs


@pytest.mark.parametrize("budget", [1, 7, 100, 1 << 26])
def test_blocked_gossip_mix_equals_the_whole_mix(budget, monkeypatch):
    """`mix_tree` in column blocks of `budget` (a leaf cut across blocks
    where it is wider) equals one call over the whole packed tree, bit
    for bit, and so does the in-place mix of the active rows."""
    g = torch.Generator().manual_seed(6)
    m = 5
    tree = {"a": torch.randn((m, 3, 4), generator=g),
            "b": {"c": torch.randn((m, 11), generator=g).to(torch.bfloat16),
                  "d": [torch.randn((m, 2), generator=g)]}}
    nbr = torch.rand((m, m), generator=g) < 0.5
    w = nbr.float() + torch.eye(m)
    w = w / w.sum(1, keepdim=True)
    idx, wl = weights_to_neighbors(w, m)
    plan = ExchangePlan("p2p", active=torch.ones(m, dtype=torch.bool),
                        weights=w, nbr_idx=idx, nbr_w=wl)
    monkeypatch.setattr(engine, "F32_BLOCK_COLUMNS", 1 << 30)
    whole = mix_tree(tree, plan, m)
    monkeypatch.setattr(engine, "F32_BLOCK_COLUMNS", budget)
    got = mix_tree(tree, plan, m)
    for a, b in zip(engine.tree_leaves(got), engine.tree_leaves(whole)):
        assert torch.equal(a, b)
    rows = torch.tensor([True, False, True, True, False])
    inplace = engine.tree_map(torch.clone, tree)
    mix_tree(inplace, plan, m, rows=rows)
    for a, b, o in zip(engine.tree_leaves(inplace),
                       engine.tree_leaves(whole), engine.tree_leaves(tree)):
        assert torch.equal(a[rows], b[rows]) and torch.equal(a[~rows],
                                                             o[~rows])
    assert engine.mix_blocks([12, 11, 2], 7) == [
        [(0, 0, 7)], [(0, 7, 12), (1, 0, 2)], [(1, 2, 9)],
        [(1, 9, 11), (2, 0, 2)]]


def test_llm_population_and_adamw_state_convert_both_ways():
    """A client-stacked LLM population (a hybrid's list of layer dicts
    included) with AdamW states crosses to the reference's layout and
    back unchanged."""
    _, cfg = _cfgs("recurrentgemma-2b")
    opt = adamw(1e-3)
    state = init_population(cfg, torch.Generator().manual_seed(7), 2, opt,
                            opt, "cpu")
    ref = convert.population_to_reference(state, family=cfg.family)
    assert isinstance(ref["extractor"]["layers"], list)
    assert set(ref["opt_e"]) == {"m", "v", "count"}
    back = convert.population_from_reference(ref, device="cpu",
                                             family=cfg.family)
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(ref)),
                    jax.tree_util.tree_leaves(to_numpy(
                        convert.population_to_reference(
                            back, family=cfg.family)))):
        np.testing.assert_array_equal(a, b)


def test_synth_tokens_follow_the_domains():
    """Each client draws most tokens from its domain's vocab slice."""
    tokens, domains = synth_tokens(0, 4, 1000, 32, seqs_per_client=8,
                                   num_domains=2)
    assert tokens.shape == (4, 8, 32) and tokens.dtype == torch.int32
    assert domains.tolist() == [0, 1, 0, 1]
    for c in range(4):
        lo = int(domains[c]) * 500
        share = ((tokens[c] >= lo) & (tokens[c] < lo + 500)).float().mean()
        assert 0.65 < float(share) < 1.0


def test_train_cli_and_federated_llm_run_one_round_on_cpu(capsys):
    """`launch.train --reduced --arch qwen2-1.5b` and the `federated_llm`
    twin, one round each on the CPU."""
    from repro_torch.examples import federated_llm
    from repro_torch.launch import train

    record = train.main(["--device", "cpu", "--arch", "qwen2-1.5b",
                         "--reduced", "--rounds", "1", "--clients", "3",
                         "--peers", "1", "--batch-size", "4",
                         "--sample-ratio", "1.0", "--eval-every", "1",
                         "--steps-per-epoch", "1", "--seq-len", "16"])
    assert np.isfinite(record["accuracy"][-1])
    assert "final personalized accuracy" in capsys.readouterr().out
    out = federated_llm.main(["--device", "cpu", "--rounds", "1",
                              "--clients", "4", "--domains", "2",
                              "--seq-len", "16"])
    text = capsys.readouterr().out
    assert "header cosine: same-domain=" in text
    assert np.isfinite(out["loss0"])


def test_make_open_spec_without_a_device_asks_for_the_card(monkeypatch):
    """`make_open_spec` and `threat_state` default to CUDA: called with no
    device where there is none they raise, instead of building the cast
    on the CPU; inert configs still return the spec itself."""
    _, cfg = _cfgs("qwen2-1.5b")
    fl = FLConfig(num_clients=4, threat=ThreatConfig(
        adversary_fraction=0.5, attack="sign_flip"))
    spec = strategies._pfeddst_spec(cfg, FLConfig(num_clients=4), 1,
                                    "pfeddst", torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ow.make_open_spec(spec, FLConfig(num_clients=4)) is spec
    with pytest.raises(RuntimeError, match="is_available"):
        ow.make_open_spec(spec, fl)
    with pytest.raises(RuntimeError, match="is_available"):
        ow.make_open_spec(spec, FLConfig(num_clients=4,
                                         churn=ChurnConfig(join_rate=0.1)))
    with pytest.raises(RuntimeError, match="is_available"):
        ow.threat_state(fl.threat, 4)
    assert ow.threat_state(fl.threat, 4, device="cpu").adversaries.device \
        == torch.device("cpu")


def test_score_kernels_take_the_widest_llm_header():
    """select_topk and raw_gram index a row's columns with 32-bit ints:
    deepseek-v3's header (final_norm + lm_head, 926,686,208 columns)
    fits, a row of 2³¹ columns is refused before any launch."""
    from repro_torch.kernels.peer_score import MAX_WIDTH, check_width

    cfg = get_config("deepseek-v3-671b")
    width = cfg.d_model * cfg.padded_vocab + cfg.d_model
    assert width == 926_686_208 < MAX_WIDTH
    check_width(width)
    with pytest.raises(ValueError, match="at most"):
        check_width(2 ** 31)
