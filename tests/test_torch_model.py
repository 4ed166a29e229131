"""The port's ResNet-18 (GroupNorm), loss and partial-freeze SGD steps
against the JAX reference, from the reference's own parameters carried
across with `repro_torch.convert`. Reduced config (`cnn_stages=(1, 1)`,
width 16) in float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.partial_freeze import make_phase_steps as ref_phase_steps
from repro.models import cnn as ref_cnn
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.models.split import split_params as ref_split
from repro.optim.sgd import sgd as ref_sgd
from repro.utils.pytree import tree_flatten_vector as ref_flatten
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.partial_freeze import make_phase_steps
from repro_torch.models import cnn, layers, model
from repro_torch.models.split import split_params
from repro_torch.optim.sgd import sgd
from repro_torch.utils.pytree import tree_flatten_vector

from test_torch_support import to_numpy, to_torch

# f32 convolutions, GroupNorm and logsumexp summed in other orders than
# XLA's CPU kernels: rtol 1e-4 / atol 1e-5 covers a few ulps per layer.
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def cfgs():
    ref_cfg = dataclasses.replace(ref_get_config("resnet18-cifar").reduced(),
                                  dtype="float32", image_size=16)
    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=16)
    return ref_cfg, cfg


@pytest.fixture(scope="module")
def params(cfgs):
    ref_cfg, _ = cfgs
    p = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    return p, convert.params_from_reference(to_numpy(p), device="cpu")


def _batch(n=3, size=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.normal(size=(n, size, size, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, size=(n,)).astype(np.int32)}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: to_torch(v) for k, v in b.items()}


def test_group_norm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 5, 16)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    want = ref_layers.group_norm(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), 8)
    got = layers.group_norm(to_torch(x), to_torch(scale), to_torch(bias), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_group_norm_bf16_normalises_in_f32_and_casts_back():
    """bf16 in, bf16 out; equal to the f32 computation rounded once."""
    x = torch.randn(2, 3, 3, 16).to(torch.bfloat16)
    s, b = torch.ones(16, dtype=torch.bfloat16), torch.zeros(16,
                                                             dtype=torch.bfloat16)
    out = layers.group_norm(x, s, b, 8)
    assert out.dtype == torch.bfloat16
    want = layers.group_norm(x.float(), s.float(), b.float(), 8)
    torch.testing.assert_close(out, want.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("size,stride,k", [(16, 2, 3), (15, 2, 3), (8, 1, 3),
                                           (16, 2, 1)])
def test_conv_same_padding_matches_xla(size, stride, k):
    """XLA 'SAME' pads a stride-2 3×3 conv on an even map as (0, 1)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, size, size, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 5)).astype(np.float32)
    want = np.asarray(ref_cnn.conv2d(jnp.asarray(x), jnp.asarray(w), stride))
    got = cnn.conv2d(to_torch(x).permute(0, 3, 1, 2),
                     to_torch(np.transpose(w, (3, 2, 0, 1))), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_cnn_forward_matches_reference(cfgs, params):
    ref_cfg, cfg = cfgs
    rp, tp = params
    b = _batch()
    want, _ = ref_model.forward(ref_cfg, rp, _jbatch(b))
    got, _ = model.forward(cfg, tp, _tbatch(b))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_loss_eval_loss_accuracy_match_reference(cfgs, params):
    ref_cfg, cfg = cfgs
    rp, tp = params
    b = _batch(n=6, seed=3)
    want, wm = ref_model.loss_fn(ref_cfg, rp, _jbatch(b))
    got, gm = model.loss_fn(cfg, tp, _tbatch(b))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)
    assert float(gm["accuracy"]) == float(wm["accuracy"])
    np.testing.assert_allclose(
        float(model.eval_loss(cfg, tp, _tbatch(b))),
        float(ref_model.eval_loss(ref_cfg, rp, _jbatch(b))),
        rtol=RTOL, atol=ATOL)
    assert float(model.accuracy(cfg, tp, _tbatch(b))) == float(
        ref_model.accuracy(ref_cfg, rp, _jbatch(b)))


def test_grouped_eval_equals_separate_evals(cfgs, params):
    """Eq. 6 probes in one forward equal one forward per probe batch."""
    _, cfg = cfgs
    _, tp = params
    imgs = torch.randn(4, 3, 16, 16, 3)
    labels = torch.randint(0, 10, (4, 3))
    got = model.eval_loss_probes(cfg, tp, {"images": imgs,
                                           "labels": labels})
    want = torch.stack([model.eval_loss(cfg, tp, {"images": imgs[g],
                                                  "labels": labels[g]})
                        for g in range(4)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_header_flatten_order_matches_reference(cfgs, params):
    """Exact: the Eq. 7 header vector is laid out as the reference's."""
    ref_cfg, cfg = cfgs
    rp, tp = params
    _, rh = ref_split(ref_cfg, rp)
    _, th = split_params(cfg, tp)
    np.testing.assert_array_equal(tree_flatten_vector(th).numpy(),
                                  np.asarray(ref_flatten(rh)))


def test_params_round_trip_through_reference_layout(params):
    rp, tp = params
    back = convert.params_to_reference(tp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(to_numpy(rp))):
        np.testing.assert_array_equal(a, b)


def _random_opt_state(tree, seed):
    """A reference sgd state with non-zero momentum, so one step also
    checks how the momentum carries."""
    rng = np.random.default_rng(seed)
    mu = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)
                              * 0.01), tree)
    return {"mu": mu, "count": jnp.int32(3)}


@pytest.mark.parametrize("phase", ["e", "h"])
def test_phase_steps_match_reference(cfgs, params, phase):
    """One phase step from a non-zero momentum: params and momentum at
    atol 1e-4. One step only: the per-position GroupNorm normalises 2
    channels per group at this width, which makes f32 training chaotic
    (tools/reference_gn_sensitivity.py), so further steps amplify f32
    rounding past any fixed tolerance in either package."""
    ref_cfg, cfg = cfgs
    rp, tp = params
    ropt = ref_sgd(0.1, momentum=0.9, weight_decay=0.005)
    topt = sgd(0.1, momentum=0.9, weight_decay=0.005)
    rsteps, tsteps = ref_phase_steps(ref_cfg, ropt), make_phase_steps(cfg, topt)
    re_, rh = ref_split(ref_cfg, rp)
    te, th = split_params(cfg, tp)
    ro = _random_opt_state(re_ if phase == "e" else rh, seed=9)
    to = {"mu": convert.params_from_reference(to_numpy(ro["mu"]),
                                              device="cpu"),
          "count": torch.tensor(3, dtype=torch.int32)}
    b = _batch(n=4, seed=4)
    if phase == "e":
        re2, ro2, rm = rsteps.phase_e(re_, rh, ro, _jbatch(b))
        te2, to2, tm = tsteps.phase_e(te, th, to, _tbatch(b))
        rtrained, ttrained, frozen_ref, frozen_t = re2, te2, rh, th
    else:
        rh2, ro2, rm = rsteps.phase_h(re_, rh, ro, _jbatch(b))
        th2, to2, tm = tsteps.phase_h(te, th, to, _tbatch(b))
        rtrained, ttrained, frozen_ref, frozen_t = rh2, th2, re_, te
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=RTOL, atol=ATOL)
    for want, got in ((rtrained, ttrained), (ro2["mu"], to2["mu"])):
        got = convert.params_to_reference(got)
        for a, b_ in zip(jax.tree_util.tree_leaves(got),
                         jax.tree_util.tree_leaves(to_numpy(want))):
            np.testing.assert_allclose(a, b_, atol=1e-4, rtol=0)
    assert int(to2["count"]) == int(ro2["count"]) == 4
    # the frozen partition is untouched
    for a, b_ in zip(jax.tree_util.tree_leaves(
            convert.params_to_reference(frozen_t)),
            jax.tree_util.tree_leaves(to_numpy(frozen_ref))):
        np.testing.assert_array_equal(a, b_)


def test_sgd_keeps_f32_momentum_for_bf16_params():
    """The reference's order: f32 grad + wd·p, f32 momentum, cast last."""
    p = {"w": torch.tensor([1.0, -2.0], dtype=torch.bfloat16)}
    g = {"w": torch.tensor([0.5, 0.25], dtype=torch.bfloat16)}
    opt = sgd(0.1, momentum=0.9, weight_decay=0.005)
    st = opt.init(p)
    upd, st = opt.update(g, st, p)
    assert st["mu"]["w"].dtype == torch.float32
    want_mu = g["w"].float() + 0.005 * p["w"].float()
    torch.testing.assert_close(st["mu"]["w"], want_mu)
    from repro_torch.optim.base import apply_updates

    new = apply_updates(p, upd)
    assert new["w"].dtype == torch.bfloat16
    torch.testing.assert_close(new["w"], p["w"] + (-0.1 * want_mu).to(
        torch.bfloat16), rtol=0, atol=0)
