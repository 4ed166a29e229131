"""The paper's six baselines: rounds of the port against live rounds of the
JAX reference (`repro.fl.engine.run_round` over the reference's own spec
stages), with the reference's draws injected and the state carried across
by each package on its own; and FedBABU's eval-time head fine-tune.

Two rounds each, M = 6, k = 2, ratio 0.5, reduced ResNet in f32 at width
32 (see tests/test_torch_round.py for why not 16). `active` and
`comm_edges` must match exactly; params, optimizer momenta and
`train_loss` at rtol 2e-3 with an absolute floor of 2e-3 × the leaf's
largest entry. dispfl's masks must match exactly, except where the
reference's |x| lies within rtol 2e-3 of its leaf's threshold: after
training the two packages' parameters differ at f32 rounding, so such an
entry may fall on either side. Those flips are counted and left out of
the parameter comparison, and the port is re-seeded from the reference
before the next round when there were any.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import FLConfig as RefFLConfig
from repro.fl.engine import named_streams as ref_named_streams
from repro.fl.engine import run_round as ref_run_round
from repro.fl.engine import sample_participants as ref_sample_participants
from repro.fl.simulator import _finetune_heads as ref_finetune_heads
from repro.fl.strategies import make_spec as ref_make_spec
from repro.kernels import ops as ref_ops
from repro.kernels.mask_evolve import magnitude_threshold
from repro_torch import convert
from repro_torch.configs import FLConfig, get_config
from repro_torch.fl import strategies
from repro_torch.fl.simulator import _finetune_heads, run_experiment
from repro_torch.kernels import gossip_mix as gm
from repro_torch.kernels import ops
from repro_torch.utils.pytree import tree_paths

from test_torch_support import _client_batch_idx, to_numpy, to_torch

M, K, BATCH, RATIO = 6, 2, 8, 0.5
WIDTH = 32
FL_KW = dict(num_clients=M, peers_per_round=K, batch_size=BATCH,
             client_sample_ratio=RATIO, epochs_extractor=1, epochs_header=1)
RTOL, ATOL = 2e-3, 1e-5


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
    return ref_cfg, cfg, ref_train, train


def reference_baseline_draws(key, key_streams, params, *, n_local: int,
                             n_steps: int, regrow: float, m: int = M,
                             ratio: float = RATIO, batch_size: int = BATCH,
                             family: str = "cnn"):
    """A reference baseline round's draws under round key `key`, keyed by
    the port's stream names: participants, local-training batches, the
    gossip uniform plane and dispfl's regrow planes (split over the
    reference's leaves in its own flatten order, then carried to the
    port's leaf names and layout: `named_leaves`' names, a flat dict of
    dotted names for the cnn and of '/'-joined paths for an LLM)."""
    keys = ref_named_streams(key, key_streams)
    idx, _ = ref_sample_participants(keys["act"], m, ratio)
    idx = np.asarray(idx)
    draws = {"act": idx, "train": np.stack([
        _client_batch_idx(ks, n_local, batch_size, total=m, rows=idx)
        for ks in jax.random.split(keys["train"], n_steps)])}
    if "nbr" in keys:
        draws["nbr"] = np.asarray(jax.random.uniform(keys["nbr"], (m, m)))
    if "grow" in keys:
        leaves, treedef = jax.tree_util.tree_flatten(params)
        gkeys = jax.random.split(keys["grow"], len(leaves))
        planes = [np.asarray(jax.random.uniform(k, leaf.shape)
                             > (1.0 - regrow))
                  for leaf, k in zip(leaves, gkeys)]
        grow = convert.params_from_reference(
            jax.tree_util.tree_unflatten(treedef, planes), device="cpu",
            family=family)
        draws["grow"] = grow if family == "cnn" else dict(tree_paths(grow))
    return draws


def _assert_tree_close(got, want, what, skip=None):
    """rtol 2e-3 with an absolute floor of 2e-3 × max |leaf| (entries near
    zero carry the absolute rounding of the leaf's large ones); entries
    where `skip` (same tree of bool arrays) is set are left out."""
    g = jax.tree_util.tree_leaves(got)
    w = jax.tree_util.tree_leaves(to_numpy(want))
    s = (jax.tree_util.tree_leaves(skip) if skip is not None
         else [None] * len(g))
    assert len(g) == len(w) == len(s), what
    for a, b, sk in zip(g, w, s):
        scale = float(np.abs(b).max())
        if sk is not None:
            a, b = a[~sk], b[~sk]
        np.testing.assert_allclose(a, b, rtol=RTOL,
                                   atol=max(ATOL, RTOL * scale),
                                   err_msg=what)


def _mask_flips(got_mask, want_mask, pre_params, keep_frac):
    """dispfl mask entries where the port and the reference disagree, as
    a tree of bool arrays (reference layout); raises unless each lies
    within rtol 2e-3 of its leaf's threshold (the reference's |x| before
    evolution against the reference's own bisection threshold)."""
    flips = jax.tree_util.tree_map(lambda a, b: np.asarray(a) != np.asarray(b),
                                   got_mask, to_numpy(want_mask))
    for flip, x in zip(jax.tree_util.tree_leaves(flips),
                       jax.tree_util.tree_leaves(to_numpy(pre_params))):
        if not flip.any():
            continue
        flat = jnp.abs(jnp.asarray(x, jnp.float32)).ravel()
        keep = max(int(flat.size * keep_frac), 1)
        thr = float(magnitude_threshold(flat, flat.size - keep))
        near = np.abs(np.abs(x[flip]) - thr) <= RTOL * thr
        assert near.all(), f"mask differs away from the threshold {thr}"
    return flips


def _reference_round(spec, ref_train, split_evolve: bool):
    """The reference round, jitted. dispfl runs as two jits, the second
    from `evolve_masks` on, so the test can read the parameters the masks
    evolve from (each stage is a function of the state and the round key
    alone, so the split changes nothing)."""
    def run(stages):
        return jax.jit(lambda st, k: ref_run_round(
            stages, st, ref_train, k, m=M, ratio=RATIO,
            key_streams=spec.key_streams))

    if not split_evolve:
        full = run(spec.stages)
        return lambda st, k: (*full(st, k), None)
    head, tail = run(spec.stages[:-2]), run(spec.stages[-2:])

    def both(st, k):
        mid, met = head(st, k)
        out, _ = tail(mid, k)
        return out, met, mid["params"]

    return both


BASELINES = ["fedavg", "fedper", "fedbabu", "dfedavgm", "dfedpgp", "dispfl"]


def _run_parity(setup, name):
    ref_cfg, cfg, ref_train, train = setup
    n_local = ref_train["images"].shape[1]
    rfl = RefFLConfig(comms=None, **FL_KW)
    fl = FLConfig(**FL_KW)
    spec = ref_make_spec(name, ref_cfg, rfl, steps_per_epoch=1)
    ref_round = _reference_round(spec, ref_train, name == "dispfl")
    strat = strategies.make_strategy(name, cfg, fl, steps_per_epoch=1,
                                     device="cpu")
    assert strat.comm_pattern == spec.comm_pattern
    assert strat.payload_kind == spec.payload_kind
    assert strat.needs_head_finetune == spec.needs_head_finetune

    rstate = spec.init(jax.random.PRNGKey(1))
    state = convert.baseline_state_from_reference(to_numpy(rstate),
                                                  device="cpu")
    total_flips = 0
    for r in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(2), r)
        draws = reference_baseline_draws(
            key, spec.key_streams, rstate["params"], n_local=n_local,
            n_steps=1, regrow=rfl.dispfl_regrow)
        rstate, rmet, pre = ref_round(rstate, key)
        state, met = strat.round(state, train, (0, r), draws=draws)
        np.testing.assert_array_equal(met["active"].numpy(),
                                      np.asarray(rmet["active"]))
        if spec.comm_pattern == "p2p":
            np.testing.assert_array_equal(met["comm_edges"].numpy(),
                                          np.asarray(rmet["comm_edges"]))
        else:
            assert "comm_edges" not in met and "comm_edges" not in rmet
        got = convert.baseline_state_to_reference(state)
        assert int(got["round"]) == int(rstate["round"]) == r + 1
        skip = None
        if name == "dispfl":
            skip = _mask_flips(got["mask"], rstate["mask"], pre,
                               1 - rfl.dispfl_sparsity)
            total_flips += sum(int(f.sum())
                               for f in jax.tree_util.tree_leaves(skip))
        _assert_tree_close(got["params"], rstate["params"], "params", skip)
        ropt = rstate["opt"]["e"] if name == "fedbabu" else rstate["opt"]
        gopt = got["opt"]["e"] if name == "fedbabu" else got["opt"]
        _assert_tree_close(gopt["mu"], ropt["mu"], "opt mu")
        np.testing.assert_array_equal(gopt["count"], np.asarray(ropt["count"]))
        scalars = {k: v for k, v in rmet.items() if np.ndim(v) == 0}
        assert set(scalars) == {k for k, v in met.items() if v.dim() == 0}
        for k, v in scalars.items():
            np.testing.assert_allclose(float(met[k]), float(v), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        if skip is not None and any(f.any() for f in
                                    jax.tree_util.tree_leaves(skip)):
            state = convert.baseline_state_from_reference(to_numpy(rstate),
                                                          device="cpu")
    return total_flips


@pytest.mark.parametrize("name", BASELINES)
def test_two_rounds_match_reference(setup, name):
    flips = _run_parity(setup, name)
    # near-tie flips are possible but must stay rare
    assert flips <= 8, flips


def test_dfedpgp_packed_plan_matches_reference_packed_mix(setup,
                                                          monkeypatch):
    """With both packages packing gossip plans on the CPU too, dfedpgp's
    directed plan (D = k + 1 = 3 ≤ M/2) mixes through the port's
    gossip_mix_plain and the reference's gossip_mix_blocked; the rounds
    still match."""
    monkeypatch.setitem(ref_ops.AUTO_MIN_SPARSE_MIX, "cpu", 1)
    monkeypatch.setattr(ops, "MIN_PACKED_MIX_CPU", 1)
    calls = []
    plain = gm.gossip_mix_plain

    def spy(x, idx, w):
        calls.append(tuple(idx.shape))
        return plain(x, idx, w)

    monkeypatch.setattr(gm, "gossip_mix_plain", spy)
    _run_parity(setup, "dfedpgp")
    assert calls == [(M, K + 1)] * 2


def test_finetune_heads_matches_reference(setup):
    """FedBABU's eval-time fine-tune (8 phase-h steps on a throwaway
    header per client), with the reference's randint draws reproduced and
    injected: rtol 2e-3 with the absolute floor."""
    ref_cfg, cfg, ref_train, _ = setup
    rfl = RefFLConfig(comms=None, **FL_KW)
    fl = FLConfig(**FL_KW)
    spec = ref_make_spec("fedbabu", ref_cfg, rfl, steps_per_epoch=1)
    params = spec.init(jax.random.PRNGKey(4))["params"]
    x, y = ref_train["images"], ref_train["labels"]
    key, steps = jax.random.PRNGKey(5), 8
    want = ref_finetune_heads(ref_cfg, rfl, params, x, y, key, steps=steps)
    idx = np.stack([
        np.stack([np.asarray(jax.random.randint(kk, (BATCH,), 0, x.shape[1]))
                  for kk in jax.random.split(kc, steps)])
        for kc in jax.random.split(key, M)], axis=1)      # (steps, M, B)
    got = _finetune_heads(cfg, fl,
                          convert.params_from_reference(to_numpy(params),
                                                        device="cpu"),
                          to_torch(x), to_torch(y), None, steps, idx=idx)
    _assert_tree_close(convert.params_to_reference(got), want, "finetune")
    before = convert.params_to_reference(
        convert.params_from_reference(to_numpy(params), device="cpu"))
    moved = [float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(convert.params_to_reference(got)["head"]),
        jax.tree_util.tree_leaves(before["head"]))]
    assert min(moved) > 0, "the headers did not train"


def test_run_experiment_runs_every_baseline_on_cpu(setup):
    """The port's simulator drives each baseline end to end (fedbabu with
    its eval-time fine-tune) and reports finite accuracy and train_loss."""
    _, cfg, _, _ = setup
    from repro_torch.data.synthetic import client_datasets_cifar

    data = client_datasets_cifar(0, M, samples_per_class=20, image_size=8)
    fl = FLConfig(**FL_KW)
    for name in BASELINES:
        hist = run_experiment(name, cfg, fl, data, num_rounds=2,
                              eval_every=2, steps_per_epoch=1, verbose=False,
                              device="cpu").to_dict()
        assert hist["rounds"] == [2], name
        assert np.isfinite(hist["accuracy"]).all(), name
        assert np.isfinite(hist["extra"]["train_loss"]).all(), name


def test_local_train_steps_matches_reference():
    from repro.fl.strategies import local_train_steps as ref_steps

    fl = FLConfig(epochs_extractor=5, epochs_header=1)
    rfl = RefFLConfig(comms=None, epochs_extractor=5, epochs_header=1)
    for name in BASELINES + ["pfeddst", "pfeddst_random"]:
        assert strategies.local_train_steps(name, fl, 2) == \
            ref_steps(name, rfl, 2)


def test_dispfl_init_masks_cover_every_leaf():
    """dispfl's initial masks: one bool plane per stacked leaf (biases and
    GroupNorm parameters included, as the reference's per-population-leaf
    masks), at about 1 − sparsity density."""
    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=8, cnn_width=WIDTH)
    strat = strategies.make_strategy("dispfl", cfg, FLConfig(**FL_KW),
                                     device="cpu")
    state = strat.init(0)
    assert set(state["mask"]) == set(state["params"])
    total = sum(m.numel() for m in state["mask"].values())
    ones = sum(int(m.sum()) for m in state["mask"].values())
    assert all(m.dtype == torch.bool and m.shape == state["params"][n].shape
               for n, m in state["mask"].items())
    assert abs(ones / total - 0.5) < 0.01


@pytest.mark.parametrize("entry", ["make_strategy", "run_experiment",
                                   "baseline_state_from_reference"])
@pytest.mark.parametrize("name", BASELINES)
def test_baseline_entry_points_without_device_need_cuda(monkeypatch, name,
                                                        entry):
    """Called without device=, the port asks for CUDA and raises where
    there is none, instead of running on the CPU."""
    from repro_torch.data.synthetic import client_datasets_cifar

    cfg = get_config("resnet18-cifar").reduced()
    fl = FLConfig(**FL_KW)
    state = convert.baseline_state_to_reference(
        strategies.make_strategy(name, cfg, fl, device="cpu").init(0))
    calls = {
        "make_strategy": lambda: strategies.make_strategy(name, cfg, fl),
        "run_experiment": lambda: run_experiment(
            name, cfg, fl, client_datasets_cifar(0, M, samples_per_class=4,
                                                 image_size=8),
            num_rounds=1),
        "baseline_state_from_reference": lambda: (
            convert.baseline_state_from_reference(state)),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        calls[entry]()
