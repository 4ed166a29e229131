"""The port's MoE, MLA and VLM serving (phi3.5-moe, deepseek-v3 with MLA,
internvl2-76b) against the JAX reference, at the reduced configs in
float32: the MLA layer by every attention route, the absorbed-weight
decode over the latent cache, flash_attention with a v head dim below
q/k's (MLA's), prefill (the reference's by "naive": its Pallas flash
kernel cannot take MLA's v head dim), decode steps and greedy
generation; the MoE condition that a prefill and a token-by-token decode
route differently; the parameter layout; and `convert` and checkpoint
round trips of the three trees.

The reference's weights go to both packages (`convert`); its calls are
jitted. On the CPU the port's "flash" route takes the plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as ref_load
from repro.checkpoint import save_checkpoint as ref_save
from repro.configs import get_config as ref_get_config
from repro.launch.serve import generate as ref_generate
from repro.models import attention as ref_attn
from repro.models import model as ref_model
from repro.utils.pytree import tree_paths as ref_tree_paths
from repro_torch import convert
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (
    flash_attention_padded, flash_attention_plain, padded_head_dim)
from repro_torch.launch.serve import generate, serving_batch
from repro_torch.models import attention, model
from repro_torch.utils.pytree import tree_paths

from test_torch_support import close_to_scale, to_numpy

PHI, DEEPSEEK, INTERNVL = ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
                           "internvl2-76b")
ARCHS = [PHI, DEEPSEEK, INTERNVL]
PROMPT, GEN, BATCH = 40, 6, 2
MIN_MARGIN = 1e-4      # the greedy picks' top-1/top-2 gap (as test_torch_serve)
TOL = 2e-5             # logits and caches, of their scale (as test_torch_serve)


def _cfgs(arch):
    return (dataclasses.replace(ref_get_config(arch).reduced(),
                                dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One reduced f32 model in both packages (the reference's weights), a
    prompt batch, and the reference's "naive" prefill."""
    arch = request.param
    rcfg, cfg = _cfgs(arch)
    rparams = jax.jit(lambda k: ref_model.init_params(rcfg, k))(
        jax.random.PRNGKey(0))
    params = convert.params_from_reference(to_numpy(rparams), device="cpu",
                                           family=cfg.family)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT)).astype(np.int32)
    rlogits, rcache = jax.jit(lambda p, t: ref_model.prefill(
        rcfg, p, {"tokens": t}, max_seq=PROMPT + GEN, backend="naive"))(
            rparams, jnp.asarray(toks))
    step = jax.jit(lambda p, c, t, pos: ref_model.decode_step(rcfg, p, c, t,
                                                              pos))
    return dict(arch=arch, rcfg=rcfg, cfg=cfg, rparams=rparams,
                params=params, toks=toks, rlogits=rlogits, rcache=rcache,
                step=step)


# ---------------------------------------------------------------------------
# flash_attention with v's head dim below q/k's
# ---------------------------------------------------------------------------

# (B, Sq, Skv, H, K, dqk, dv, causal): MLA's reduced 48/32, and 192/128
MLA_FLASH_CASES = [(2, 70, 70, 4, 4, 48, 32, True),
                   (1, 40, 90, 4, 2, 48, 32, False),
                   (1, 130, 130, 2, 2, 192, 128, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLA_FLASH_CASES,
                         ids=lambda c: "b{}-q{}-kv{}-h{}-k{}-d{}-v{}-c{}"
                         .format(*(int(x) for x in c)))
def test_flash_attention_dv_below_dqk_matches_reference_naive(case, dtype):
    """`ops.flash_attention` (the plain version on the CPU, taking
    dv < dqk directly) and the CUDA wrapper's route through the plain
    version (`flash_attention_padded`: q, k and v zero-padded to the
    kernel instance of dqk, the output cut to dv), against the reference's `attend(backend="naive")` on the
    same values: f32 within 1e-5 of the scale; bf16 within one bf16 ulp
    of the reference's f32 result rounded (both compute in f32)."""
    b, sq, skv, h, kh, dqk, dv, causal = case
    rng = np.random.default_rng(sum(case))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(tdt) for shape in ((b, sq, h, dqk), (b, skv, kh, dqk),
                                      (b, skv, kh, dv)))
    want = np.asarray(ref_attn.attend(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), causal=causal,
        backend="naive"))
    seen = []

    def plain(*args, **kwargs):
        seen.append(tuple(t.shape[-1] for t in args))
        return flash_attention_plain(*args, **kwargs)

    padded = flash_attention_padded(plain, q, k, v, causal=causal)
    assert seen == [(padded_head_dim(dqk),) * 3]
    for got in (ops.flash_attention(q, k, v, causal=causal), padded):
        assert got.shape == (b, sq, h, dv) and got.dtype == tdt
        if dtype == "float32":
            close_to_scale(got.numpy(), want, 1e-5)
        else:
            assert ref.within_ulps(got, torch.tensor(want).to(tdt))
    with pytest.raises(ValueError, match="v head dim"):
        ops.flash_attention(q, k, torch.cat([v, v, v], dim=-1))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_setup(seed=3):
    rcfg, cfg = _cfgs(DEEPSEEK)
    rp = jax.jit(lambda k: ref_attn.init_mla(k, rcfg))(
        jax.random.PRNGKey(seed))
    p = convert.params_from_reference(to_numpy(rp), device="cpu",
                                      family="moe")
    return rcfg, cfg, rp, p


def test_mla_layer_matches_reference():
    """The MLA layer over 2 × 60 tokens (q/k head dim 48, v 32) by the
    port's flash (plain), naive and chunked routes against the
    reference's naive and chunked (its flash route raises on MLA, see
    ROADMAP §3): within 1e-5 of the output's scale; the latent c_kv and
    rope key within 1e-5."""
    rcfg, cfg, rp, p = _mla_setup()
    x = np.random.default_rng(0).normal(size=(2, 60, cfg.d_model)).astype(
        np.float32)
    pos = np.arange(60)[None]
    wants = [np.asarray(jax.jit(lambda p, x, b=b: ref_attn.mla_layer(
        p, x, jnp.asarray(pos), rcfg, backend=b))(rp, jnp.asarray(x)))
        for b in ("naive", "chunked")]
    for backend in ("flash", "naive", "chunked"):
        got = attention.mla_layer(p, torch.from_numpy(x),
                                  torch.from_numpy(pos), cfg,
                                  backend=backend).numpy()
        for want in wants:
            close_to_scale(got, want, 1e-5, backend)
    q, k, v, c_kv, k_rope = attention.mla_qkv_full(
        p, torch.from_numpy(x), torch.from_numpy(pos), cfg)
    assert q.shape[-1] == k.shape[-1] == 48 and v.shape[-1] == 32
    assert q.is_contiguous() and k.is_contiguous()
    rq, rk, rv, rc, rr = ref_attn._mla_qkv_full(rp, jnp.asarray(x),
                                                jnp.asarray(pos), rcfg)
    for got, want in ((q, rq), (k, rk), (v, rv), (c_kv, rc), (k_rope, rr)):
        close_to_scale(got.numpy(), np.asarray(want), 1e-5)


def test_mla_decode_matches_reference():
    """12 absorbed-weight decode steps into a zero latent cache of 16
    slots: each step's output within 1e-5 of the reference's scale, the
    cache (written in place) within 1e-5; slots past pos stay zero."""
    rcfg, cfg, rp, p = _mla_setup(4)
    x = np.random.default_rng(1).normal(size=(2, 12, cfg.d_model)).astype(
        np.float32)
    rcache = ref_attn.init_mla_cache(rcfg, 2, 16)
    cache = attention.init_mla_cache(cfg, 2, 16, "cpu")
    step = jax.jit(lambda p, x, c, t: ref_attn.mla_decode(p, x, c, t, rcfg))
    for t in range(12):
        rout, rcache = step(rp, jnp.asarray(x[:, t:t + 1]), rcache, t)
        out, same = attention.mla_decode(p, torch.from_numpy(x[:, t:t + 1]),
                                         cache, t, cfg)
        assert same is cache and out.shape == (2, 1, cfg.d_model)
        close_to_scale(out.numpy(), np.asarray(rout), 1e-5, t)
        for name in ("c_kv", "k_rope"):
            close_to_scale(cache[name].numpy(), np.asarray(rcache[name]),
                           1e-5, name)
    assert not cache["c_kv"][:, 12:].any()


# ---------------------------------------------------------------------------
# the three configs served
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["flash", "naive"])
def test_prefill_matches_reference(served, backend):
    """Prefill logits within TOL of the reference's ("naive") and the
    cache (k/v, or MLA's c_kv and k_rope) filled up to the prompt, zeros
    after, within TOL."""
    cfg = served["cfg"]
    logits, cache = model.prefill(
        cfg, served["params"], {"tokens": torch.from_numpy(served["toks"])},
        max_seq=PROMPT + GEN, backend=backend)
    assert logits.shape == (BATCH, PROMPT, cfg.padded_vocab)
    close_to_scale(logits.numpy(), np.asarray(served["rlogits"]), TOL)
    got = convert.flatten_tree(cache)
    want = convert.flatten_tree(to_numpy(served["rcache"]))
    assert set(got) == set(want) == ({"c_kv", "k_rope"} if cfg.use_mla
                                     else {"k", "v"})
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        close_to_scale(got[name].numpy(), w, TOL, name)
        assert not got[name][:, :, PROMPT:].any()


def test_decode_steps_match_reference(served):
    """Three decode steps from the prefilled cache: logits and the cache,
    updated in place, within TOL of the reference's."""
    cfg, rcfg = served["cfg"], served["rcfg"]
    _, cache = model.prefill(cfg, served["params"],
                             {"tokens": torch.from_numpy(served["toks"])},
                             max_seq=PROMPT + GEN)
    rcache = served["rcache"]
    for i in range(3):
        nxt = np.array([[3 + i], [cfg.vocab_size - 1 - i]], np.int32)
        logits, cache = model.decode_step(cfg, served["params"], cache,
                                          torch.from_numpy(nxt), PROMPT + i)
        rlogits, rcache = served["step"](served["rparams"], rcache,
                                         jnp.asarray(nxt), PROMPT + i)
        close_to_scale(logits.numpy(), np.asarray(rlogits), TOL, i)
    got = convert.flatten_tree(cache)
    for name, want in convert.flatten_tree(to_numpy(rcache)).items():
        close_to_scale(got[name].numpy(), want, TOL, name)


def test_greedy_generation_matches_reference(served):
    """Greedy tokens of the port's generate equal the reference's
    `launch.serve.generate`, every pick's top-1/top-2 gap above
    MIN_MARGIN; the vlm family's serving batch is its tokens alone."""
    cfg, params, toks = served["cfg"], served["params"], served["toks"]
    assert set(serving_batch(cfg, torch.from_numpy(toks))) == {"tokens"}
    logits, cache = model.prefill(cfg, params,
                                  {"tokens": torch.from_numpy(toks)},
                                  max_seq=PROMPT + GEN)
    logits = logits[:, -1:]
    margin = np.inf
    for i in range(GEN):
        top2 = logits[:, -1, :cfg.vocab_size].topk(2, dim=-1).values
        margin = min(margin, float((top2[:, 0] - top2[:, 1]).min()))
        nxt = logits[:, -1, :cfg.vocab_size].argmax(-1).to(torch.int32)
        logits, cache = model.decode_step(cfg, params, cache, nxt[:, None],
                                          PROMPT + i)
    assert margin > MIN_MARGIN, margin
    want = np.asarray(jax.jit(lambda p, t: ref_generate(
        served["rcfg"], p, t, gen_tokens=GEN))(served["rparams"],
                                               jnp.asarray(toks)))
    got = generate(cfg, params, torch.from_numpy(toks), gen_tokens=GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_moe_prefill_differs_from_decode_in_both_packages():
    """A reference condition (ROADMAP §3): the prefill routes all B·S
    tokens as one group (capacity 20 here) and drops, a decode step
    routes B tokens (capacity 4) and drops none. With 16 equal prompt
    tokens every token routes alike, so the prefill drops 12 of the 32
    top-1 picks; its last logits then differ from decoding the prompt
    token by token, in both packages by the same amount, while each
    route agrees across the packages within TOL."""
    rcfg, cfg = _cfgs(PHI)
    rparams = jax.jit(lambda k: ref_model.init_params(rcfg, k))(
        jax.random.PRNGKey(5))
    params = convert.params_from_reference(to_numpy(rparams), device="cpu",
                                           family="moe")
    s = 16
    toks = np.full((BATCH, s), 7, np.int32)
    rpre, _ = jax.jit(lambda p, t: ref_model.prefill(
        rcfg, p, {"tokens": t}, max_seq=s, backend="naive"))(
            rparams, jnp.asarray(toks))
    pre, _ = model.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                           max_seq=s)
    rcache = ref_model.init_cache(rcfg, BATCH, s)
    cache = model.init_cache(cfg, BATCH, s, "cpu")
    step = jax.jit(lambda p, c, t, pos: ref_model.decode_step(rcfg, p, c, t,
                                                              pos))
    for t in range(s):
        rdec, rcache = step(rparams, rcache, jnp.asarray(toks[:, t:t + 1]),
                            t)
        dec, cache = model.decode_step(cfg, params, cache,
                                       torch.from_numpy(toks[:, t:t + 1]), t)
    rpre, rdec = np.asarray(rpre[:, -1]), np.asarray(rdec[:, 0])
    pre, dec = pre[:, -1].numpy(), dec[:, 0].numpy()
    close_to_scale(pre, rpre, TOL, "prefill")
    close_to_scale(dec, rdec, TOL, "decode")
    gap, rgap = float(np.abs(pre - dec).max()), float(np.abs(rpre - rdec).max())
    assert rgap > 1e-2 and gap > 1e-2, (gap, rgap)
    assert abs(gap - rgap) <= TOL * max(1.0, float(np.abs(rpre).max()))


# ---------------------------------------------------------------------------
# trees: convert and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_trees_round_trip_convert_and_checkpoints(arch, tmp_path):
    """The reduced bf16 trees (stacked (L, E, …) experts, router, shared
    expert, MLA leaves, vision_proj): the port's own init has the
    reference's paths, shapes and dtypes; `convert` carries the
    reference's tree over bitwise, with no transpose, and back; the
    reference's checkpoint restores into the port's tree bitwise, and
    the port's into the reference's."""
    rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    rparams = jax.jit(lambda k: ref_model.init_params(rcfg, k))(
        jax.random.PRNGKey(6))
    like = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want_paths = [(p, a.shape, str(a.dtype))
                  for p, a in ref_tree_paths(rparams)]
    assert [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in tree_paths(like)] == want_paths
    names = {p for p, _, _ in want_paths}
    if cfg.num_experts:
        assert {"layers/moe/experts/wi", "layers/moe/router"} <= names
    if cfg.use_mla:
        assert {"layers/attn/wkv_b", "layers/moe/shared/wo"} <= names
    if cfg.family == "vlm":
        assert "vision_proj" in names
    port = convert.params_from_reference(to_numpy(rparams), device="cpu",
                                         family=cfg.family)
    for (p, t), (_, a) in zip(tree_paths(port), ref_tree_paths(rparams)):
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16), p)
    back = convert.params_to_reference(port, family=cfg.family)
    for (p, a), (_, b) in zip(ref_tree_paths(back), ref_tree_paths(rparams)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32), p)
    got, _ = load_checkpoint(ref_save(str(tmp_path / "ref"), 0, rparams),
                             like=like, device="cpu")
    for (p, a), (_, b) in zip(tree_paths(got), tree_paths(port)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), p
    rback, _ = ref_load(save_checkpoint(str(tmp_path / "port"), 1, like),
                        like=rparams)
    for (p, a), (_, t) in zip(ref_tree_paths(rback), tree_paths(like)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int16),
                                      t.view(torch.int16).numpy(), p)
