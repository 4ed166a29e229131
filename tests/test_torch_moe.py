"""The port's MoE layer (`repro_torch.models.moe`) against the JAX
reference `repro.models.moe`, in float32 at the reduced phi3.5-moe and
deepseek-v3 configs (4 experts, top-2), in both dispatch modes: outputs,
the aux losses, and the routing (`gate_idx`, the queue positions and
`keep`, compared exactly) for random tokens, the reference's
identical-token capacity-drop input, a padded last group whose padding
displaces a real assignment, deepseek's shared expert, and a
decode-sized group (T = B).

The reference's weights go to both packages (`convert`). The reference
returns no routing, so `_ref_route` runs its routing lines (`moe_layer`
:70-98) in jax. Every comparison asserts the margin it relies on: the
gaps between a real token's first K + 1 router probabilities exceed the
measured difference of the two packages' probabilities.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import moe

from test_torch_support import close_to_scale, to_numpy

PHI, DEEPSEEK = "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"
# outputs and aux within this much of their scale (f32; the two packages'
# GEMMs sum in different orders, measured ≤ 1e-6)
TOL = 1e-5

_ref_layer = jax.jit(ref_moe.moe_layer,
                     static_argnames=("cfg", "group_size", "dispatch_mode"))


def _setup(arch, seed):
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    rp = jax.jit(ref_moe.init_moe, static_argnames="cfg")(
        jax.random.PRNGKey(seed), cfg=rcfg)
    p = convert.params_from_reference(to_numpy(rp), device="cpu",
                                      family="moe")
    return rcfg, cfg, rp, p


def _ref_route(p, x, cfg, group_size=None):
    """The reference's routing (`moe_layer` :70-98, its lines) → numpy
    probs, gate_idx, pos_in_expert and keep, and T."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    Tg = min(group_size or ref_moe.GROUP_SIZE, T)
    pad = (-T) % Tg
    xt = x.reshape(T, D)
    if pad:
        xt = jnp.pad(xt, ((0, pad), (0, 0)))
    G = (T + pad) // Tg
    C = ref_moe.moe_capacity(Tg, E, K)
    xg = xt.reshape(G, Tg, D)
    logits = jnp.einsum("gtd,de->gte", xg, p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    flat = onehot.transpose(0, 2, 1, 3).reshape(G, K * Tg, E)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = pos.reshape(G, K, Tg, E).transpose(0, 2, 1, 3)
    pos_in_expert = jnp.sum(pos * onehot, axis=-1)
    return dict(probs=np.asarray(probs), gate_idx=np.asarray(gate_idx),
                pos=np.asarray(pos_in_expert),
                keep=np.asarray(pos_in_expert < C), T=T, C=C)


def _check(arch, x_np, *, group_size=None, seed=0):
    """Both packages' routing and layer on x (B, S, D) f32: routing equal
    exactly, with the margin asserted; outputs and aux within TOL, in
    both dispatch modes. → (the port's routing, the reference's)."""
    rcfg, cfg, rp, p = _setup(arch, seed)
    K = cfg.num_experts_per_tok
    x, xt = jnp.asarray(x_np), torch.from_numpy(x_np)
    want = _ref_route(rp, x, rcfg, group_size)
    got = moe.moe_route(p, xt, cfg, group_size=group_size)
    assert got["C"] == want["C"]
    probs = got["probs"].numpy()
    diff = float(np.abs(probs - want["probs"]).max())
    top = -np.sort(-want["probs"], axis=-1)[..., :K + 1]
    gaps = (top[..., :-1] - top[..., 1:]).min(-1).reshape(-1)
    assert gaps[:want["T"]].min() > diff, (gaps[:want["T"]].min(), diff)
    # padding rows (logits exactly 0) tie exactly in both packages
    np.testing.assert_array_equal(probs.reshape(-1, probs.shape[-1])[
        want["T"]:], want["probs"].reshape(-1, probs.shape[-1])[want["T"]:])
    for name in ("gate_idx", "pos", "keep"):
        np.testing.assert_array_equal(got[name].numpy(), want[name], name)
    for mode in ("gather", "einsum"):
        rout, raux = _ref_layer(rp, x, cfg=rcfg, group_size=group_size,
                                dispatch_mode=mode)
        with moe.recording_routes() as seen:
            out, aux = moe.moe_layer(p, xt, cfg, group_size=group_size,
                                     dispatch_mode=mode)
        assert len(seen) == 1
        for a, name in zip(seen[0], ("gate_idx", "keep")):
            np.testing.assert_array_equal(
                a.numpy(), want[name].reshape(-1, K)[:want["T"]], name)
        assert out.shape == xt.shape and out.dtype == xt.dtype
        close_to_scale(out.numpy(), np.asarray(rout), TOL, mode)
        assert set(aux) == set(raux)
        for name, v in aux.items():
            assert v.dtype == torch.float32 and v.dim() == 0
            close_to_scale(v.numpy(), np.asarray(raux[name]), TOL, name)
    return got, want


@pytest.mark.parametrize("arch", [PHI, DEEPSEEK])
def test_moe_layer_matches_reference(arch):
    """Random tokens (2 × 24): routing equal, outputs and aux within TOL;
    deepseek's always-on shared expert is in its output."""
    d = get_config(arch).reduced().d_model
    x = np.random.default_rng(1).normal(size=(2, 24, d)).astype(np.float32)
    _check(arch, x)
    if arch == DEEPSEEK:
        _, cfg, _, p = _setup(arch, 0)
        p0 = dict(p, shared={k: torch.zeros_like(v)
                             for k, v in p["shared"].items()})
        a, _ = moe.moe_layer(p, torch.from_numpy(x), cfg)
        b, _ = moe.moe_layer(p0, torch.from_numpy(x), cfg)
        assert float((a - b).abs().max()) > 1e-6


def test_moe_capacity_drop_matches_reference():
    """The reference's capacity-drop input (`tests/test_attention.py`):
    64 identical tokens route alike, so each of their two experts gets 64
    assignments for 40 slots; the drops are equal in both packages."""
    d = get_config(PHI).reduced().d_model
    row = np.random.default_rng(5).normal(size=(1, 1, d)).astype(np.float32)
    got, want = _check(PHI, np.broadcast_to(row, (2, 32, d)).copy())
    assert want["C"] == 40
    assert int((~got["keep"]).sum()) == 2 * (64 - 40)


def test_moe_padding_displaces_a_real_assignment():
    """22 tokens in groups of 16: the last group holds 6 real tokens and
    10 zero rows. The zero rows' uniform probabilities tie, so both
    packages give them experts 0 and 1 (lower index first), and their
    top-1 picks of expert 0 queue before the real tokens' top-2 picks:
    tokens 18 and 19 (top-1 expert 1, top-2 expert 0) lose their second
    assignment to the padding, in both packages alike."""
    rcfg, cfg, rp, _ = _setup(PHI, 2)
    router = np.asarray(rp["router"], np.float64)          # (D, E)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(22, cfg.d_model))
    # tokens 16–19: exact router logits through the router's pseudo-inverse
    target = np.array([[2.0, 1.0, 0.0, 0.0], [2.0, 1.0, 0.0, 0.0],
                       [1.0, 2.0, 0.0, 0.0], [1.0, 2.0, 0.0, 0.0]])
    x[16:20] = target @ np.linalg.pinv(router)
    got, want = _check(PHI, x[None].astype(np.float32), group_size=16,
                       seed=2)
    assert want["C"] == 12
    gate_idx, pos, keep = (got[n].numpy() for n in ("gate_idx", "pos",
                                                    "keep"))
    # group 1 rows 0–5 are tokens 16–21; rows 6–15 the padding
    np.testing.assert_array_equal(gate_idx[1, 6:], [[0, 1]] * 10)
    assert gate_idx[1, 2:4].tolist() == [[1, 0], [1, 0]]
    assert not keep[1, 2:4, 1].any()
    # without the 10 padding picks ahead of them they would be kept
    assert (pos[1, 2:4, 1] - 10 < want["C"]).all()


def test_moe_decode_sized_group_matches_reference():
    """A decode step's group (T = B = 4 tokens, capacity 4): no drops;
    deepseek with its shared expert."""
    d = get_config(DEEPSEEK).reduced().d_model
    x = np.random.default_rng(4).normal(size=(4, 1, d)).astype(np.float32)
    got, _ = _check(DEEPSEEK, x)
    assert got["C"] == 4 and bool(got["keep"].all())


def test_topk_lower_index_breaks_ties_like_lax():
    """Exact ties (quantised values) go to the lower index, as
    `jax.lax.top_k`; values equal too."""
    x = np.random.default_rng(0).integers(0, 4, size=(64, 16)).astype(
        np.float32) / 4
    for k in (1, 2, 8):
        vals, idx = moe.topk_lower_index(torch.from_numpy(x), k)
        rvals, ridx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))


def test_moe_capacity_and_constants_match_reference():
    assert (moe.CAPACITY_FACTOR, moe.GROUP_SIZE) == (
        ref_moe.CAPACITY_FACTOR, ref_moe.GROUP_SIZE)
    for tg, e, k in ((4096, 16, 2), (4096, 256, 8), (4, 256, 8), (4, 16, 2),
                     (80, 4, 2), (17, 3, 1)):
        assert moe.moe_capacity(tg, e, k) == ref_moe.moe_capacity(tg, e, k)
    assert moe.moe_capacity(4096, 16, 2) == 640
    assert moe.moe_capacity(4096, 256, 8) == 160


def test_unknown_dispatch_mode_raises():
    _, cfg, _, p = _setup(PHI, 0)
    with pytest.raises(ValueError, match="dispatch mode"):
        moe.moe_layer(p, torch.zeros(1, 2, cfg.d_model), cfg,
                      dispatch_mode="scatter")
