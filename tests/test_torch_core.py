"""PFedDST core of the port — selection, scoring, aggregation, data —
against the JAX reference on fixed inputs. Masks and indices must match
exactly; float results at the tolerance each test states."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import aggregation as ref_agg
from repro.core import scoring as ref_scoring
from repro.core import selection as ref_sel
from repro.data import synthetic as ref_synth
from repro.models import model as ref_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import aggregation, scoring, selection
from repro_torch.data import synthetic

from test_torch_support import to_numpy, to_torch


def _scores(m=7, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(m, m)).astype(np.float32)
    return s, rng.uniform(size=(m, m)) < 0.6


@pytest.mark.parametrize("k", [0, 1, 3, 6, 9])
@pytest.mark.parametrize("with_cand", [False, True])
def test_select_peers_topk_matches_reference(k, with_cand):
    """Exact, including k = 0 (explicit empty mask) and k ≥ M."""
    s, cand = _scores()
    c = cand if with_cand else None
    want = ref_sel.select_peers(jnp.asarray(s), k=k,
                                candidate_mask=None if c is None
                                else jnp.asarray(c))
    got = selection.select_peers(to_torch(s), k=k,
                                 candidate_mask=None if c is None
                                 else to_torch(c))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_peers_threshold_matches_reference():
    s, cand = _scores(seed=1)
    for c in (None, cand):
        want = ref_sel.select_peers(jnp.asarray(s), threshold=0.2,
                                    candidate_mask=None if c is None
                                    else jnp.asarray(c))
        got = selection.select_peers(to_torch(s), threshold=0.2,
                                     candidate_mask=None if c is None
                                     else to_torch(c))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_to_mask_drops_floor_picks():
    """Exact: picks at the NEG floor (too few candidates) are dropped."""
    idx = np.array([[1, 2], [0, 2], [0, 1]], np.int32)
    vals = np.array([[0.5, ref_sel.NEG], [0.1, 0.2], [ref_sel.NEG] * 2],
                    np.float32)
    want = ref_sel.topk_to_mask(jnp.asarray(idx), jnp.asarray(vals), 3)
    got = selection.topk_to_mask(to_torch(idx), to_torch(vals), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_update_recency_and_recency_scores():
    rng = np.random.default_rng(2)
    last = rng.integers(-1, 4, size=(5, 5)).astype(np.int32)
    mask = rng.uniform(size=(5, 5)) < 0.4
    want = ref_sel.update_recency(jnp.asarray(last), jnp.asarray(mask),
                                  jnp.int32(5))
    got = selection.update_recency(to_torch(last), to_torch(mask),
                                   torch.tensor(5, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    np.testing.assert_allclose(
        scoring.recency_scores(to_torch(last), 5, 0.5).numpy(),
        np.asarray(ref_scoring.recency_scores(jnp.asarray(last), 5, 0.5)),
        rtol=1e-6)


def test_combined_scores_scalar_and_matrix_cost():
    rng = np.random.default_rng(3)
    s_l, s_d, s_p, c = (rng.uniform(size=(6, 6)).astype(np.float32)
                        for _ in range(4))
    for cost in (1.0, c):
        want = ref_sel.combined_scores(jnp.asarray(s_l), jnp.asarray(s_d),
                                       jnp.asarray(s_p), alpha=0.7,
                                       comm_cost=jnp.asarray(cost))
        got = selection.combined_scores(
            to_torch(s_l), to_torch(s_d), to_torch(s_p), alpha=0.7,
            comm_cost=to_torch(cost) if np.ndim(cost) else cost)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    with pytest.raises(ValueError):
        selection.as_cost_matrix(torch.ones(5, 5), 6)


def test_selection_weights_and_aggregate_extractors():
    """weights rtol 1e-6; aggregate_extractors rtol 1e-6 (f32 sums)."""
    rng = np.random.default_rng(4)
    mask = rng.uniform(size=(5, 5)) < 0.5
    want_w = ref_agg.selection_to_weights(jnp.asarray(mask))
    got_w = aggregation.selection_to_weights(to_torch(mask))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6)
    tree = {"a": rng.normal(size=(5, 3, 2)).astype(np.float32),
            "b": {"c": rng.normal(size=(5, 4)).astype(np.float32)}}
    want = ref_agg.aggregate_extractors(
        jax.tree_util.tree_map(jnp.asarray, tree), want_w)
    got = aggregation.aggregate_extractors(
        {"a": to_torch(tree["a"]), "b.c": to_torch(tree["b"]["c"])}, got_w)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["b.c"].numpy(),
                               np.asarray(want["b"]["c"]), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_header_distance_matrix_matches_reference(use_kernel):
    x = np.random.default_rng(5).normal(size=(6, 40)).astype(np.float32)
    want = ref_scoring.header_distance_matrix(jnp.asarray(x),
                                              use_kernel=use_kernel)
    got = scoring.header_distance_matrix(to_torch(x), use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_score_topk_and_selected_components_match_reference():
    """Indices exact; values, stats and components rtol 1e-5."""
    rng = np.random.default_rng(6)
    m, k = 8, 3
    x = rng.normal(size=(m, 30)).astype(np.float32)
    last = rng.integers(-1, 2, size=(m, m)).astype(np.int32)
    s_l = rng.uniform(1.0, 3.0, size=(m, m)).astype(np.float32)
    cost = rng.uniform(0.5, 1.5, size=(m, m)).astype(np.float32)
    kw = dict(alpha=1.0, lam=0.5, k=k)
    rv, ri, rs = ref_scoring.score_topk(
        jnp.asarray(x), jnp.asarray(last), jnp.asarray(s_l), 2,
        comm_cost=jnp.asarray(cost), **kw)
    v, i, s = scoring.score_topk(to_torch(x), to_torch(last), to_torch(s_l),
                                 torch.tensor(2), comm_cost=to_torch(cost),
                                 **kw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5,
                               atol=1e-6)
    want = ref_scoring.selected_components(
        jnp.asarray(x), jnp.asarray(last), jnp.asarray(s_l), 2, ri,
        alpha=1.0, lam=0.5, comm_cost=jnp.asarray(cost))
    got = scoring.selected_components(
        to_torch(x), to_torch(last), to_torch(s_l), 2, i, alpha=1.0,
        lam=0.5, comm_cost=to_torch(cost))
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        scoring.score_topk(to_torch(x), to_torch(last), to_torch(s_l), 2,
                           comm_cost=torch.ones(3, 3), **kw)


def test_loss_disparity_rows_matches_reference():
    """rtol 1e-4 (f32 forward passes, as in test_torch_model)."""
    ref_cfg = dataclasses.replace(ref_get_config("resnet18-cifar").reduced(),
                                  dtype="float32", image_size=8)
    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=8)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    rp = jax.vmap(lambda k: ref_model.init_params(ref_cfg, k))(keys)
    rng = np.random.default_rng(7)
    probe = {"images": rng.normal(size=(3, 4, 8, 8, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, size=(3, 4)).astype(np.int32)}
    want = ref_scoring.loss_disparity_rows(
        ref_cfg, rp, jax.tree_util.tree_map(jnp.asarray, probe))
    got = scoring.loss_disparity_rows(
        cfg, convert.params_from_reference(to_numpy(rp), device="cpu"),
        {k: to_torch(v) for k, v in probe.items()})
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_partition_matches_reference_in_distribution():
    """The port's own data: same shapes and the paper's class budget
    (each client's train and test splits share ≤ 2 classes), like the
    reference's generator."""
    ref = ref_synth.client_datasets_cifar(jax.random.PRNGKey(0), 8,
                                          samples_per_class=30,
                                          image_size=8)
    got = synthetic.client_datasets_cifar(0, 8, samples_per_class=30,
                                          image_size=8)
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
    for i in range(8):
        tr = set(got["train_y"][i].tolist())
        assert len(tr) <= 2 and set(got["test_y"][i].tolist()) == tr
    # class-balanced overall, like the reference's stream
    counts = np.bincount(got["train_y"].reshape(-1).numpy(), minlength=10)
    want = np.bincount(np.asarray(ref["train_y"]).reshape(-1), minlength=10)
    np.testing.assert_array_equal(np.sort(counts), np.sort(want))
    assert torch.isfinite(got["train_x"]).all()
