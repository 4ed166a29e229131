"""The port's hybrid family (recurrentgemma-2b: RG-LRU blocks and
sliding-window attention) against the JAX reference, at the reduced
config in float32: the RG-LRU pieces, the window ring decode, prefill by
both of the reference's routes, decode steps, greedy generation, and
prefill-then-decode against decode-all.

The same weights (the reference's init, carried across by
`convert.params_from_reference`) and the same numpy inputs go to both
packages. The reduced window is 16 and the prompts 40 tokens, so the ring
wraps twice in the prefill; the reference's Pallas flash kernel runs in
interpret mode, the port's "flash" route takes the plain version on the
CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.serve import generate as ref_generate
from repro.models import attention as ref_attn
from repro.models import model as ref_model
from repro.models import rglru as ref_rglru
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.serve import generate, serve_requests
from repro_torch.models import attention, model, rglru

from test_torch_support import close_to_scale, to_numpy

ARCH = "recurrentgemma-2b"
PROMPT, GEN, BATCH = 40, 8, 2
MIN_MARGIN = 1e-4      # the greedy picks' top-1/top-2 gap (as test_torch_serve)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def hyb():
    """Reduced f32 recurrentgemma in both packages (the reference's
    weights), a prompt batch, and the reference's prefill by both routes."""
    rcfg = dataclasses.replace(ref_get_config(ARCH).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    assert cfg.window_size == 16 and cfg.block_pattern == ("rec", "rec",
                                                           "attn")
    # the reference jitted: its eager associative_scan compiles op by op
    rparams = jax.jit(lambda k: ref_model.init_params(rcfg, k))(
        jax.random.PRNGKey(0))
    params = convert.params_from_reference(to_numpy(rparams), device="cpu",
                                           family=cfg.family)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT)).astype(np.int32)
    ref_out = {
        backend: jax.jit(lambda p, t, backend=backend: ref_model.prefill(
            rcfg, p, {"tokens": t}, max_seq=PROMPT + GEN,
            backend=backend))(rparams, jnp.asarray(toks))
        for backend in ("naive", "flash")}
    ref_step = jax.jit(lambda p, st, t, pos: ref_model.decode_step(
        rcfg, p, st, t, pos))
    return dict(rcfg=rcfg, cfg=cfg, rparams=rparams, params=params,
                toks=toks, ref=ref_out, ref_step=ref_step)


# ---------------------------------------------------------------------------
# the RG-LRU pieces
# ---------------------------------------------------------------------------

def _rec_block(hyb):
    """The first rec layer's block weights in both packages."""
    return hyb["rparams"]["layers"][0]["temporal"], \
        hyb["params"]["layers"][0]["temporal"]


@pytest.mark.parametrize("with_tail", [False, True])
def test_conv1d_matches_reference(hyb, with_tail):
    """The width-4 causal conv and its new tail: f32 within 1e-6 of the
    scale (four products summed in the same order)."""
    rp, p = _rec_block(hyb)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 11, hyb["cfg"].lru_width)).astype(np.float32)
    tail = rng.normal(size=(2, 3, x.shape[2])).astype(np.float32) \
        if with_tail else None
    want, want_tail = ref_rglru._conv1d(
        rp, jnp.asarray(x), None if tail is None else jnp.asarray(tail))
    got, got_tail = rglru._conv1d(p, _t(x), None if tail is None else _t(tail))
    close_to_scale(got.numpy(), np.asarray(want), 1e-6, "out")
    np.testing.assert_array_equal(got_tail.numpy(), np.asarray(want_tail))


@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_scan_matches_reference(hyb, with_h0):
    """The doubling scan against the reference's associative_scan over 40
    steps: h and the last h within 2e-6 of the scale (measured ≤ 3.6e-7:
    the two associate the products differently)."""
    rp, p = _rec_block(hyb)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, PROMPT, hyb["cfg"].lru_width)).astype(np.float32)
    h0 = rng.normal(size=(2, x.shape[2])).astype(np.float32) if with_h0 \
        else None
    want, want_last = jax.jit(ref_rglru.rg_lru_scan)(
        rp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    got, got_last = rglru.rg_lru_scan(p, _t(x), None if h0 is None
                                      else _t(h0))
    assert got_last.dtype == torch.float32
    close_to_scale(got.numpy(), np.asarray(want), 2e-6, "h")
    close_to_scale(got_last.numpy(), np.asarray(want_last), 2e-6, "last")


def test_linear_scan_equals_sequential_recurrence():
    """The doubling scan at a length that is not a power of two, against
    the recurrence h_t = a_t h_{t−1} + b_t run step by step in f64: within
    1e-6 of the scale in f32."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0.5, 1.0, size=(2, 37, 5)).astype(np.float32)
    b = rng.normal(size=(2, 37, 5)).astype(np.float32)
    h = np.zeros((2, 5))
    want = []
    for t in range(37):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        want.append(h)
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    close_to_scale(got.numpy(), np.stack(want, 1), 1e-6)


def test_rg_lru_step_and_block_step_match_reference(hyb):
    """One decode step of the LRU and of the whole block (conv tail, gate,
    projections): within 1e-6 of the scale (measured ≤ 4.5e-7)."""
    rp, p = _rec_block(hyb)
    cfg = hyb["cfg"]
    rng = np.random.default_rng(5)
    x1 = rng.normal(size=(2, cfg.lru_width)).astype(np.float32)
    h = rng.normal(size=(2, cfg.lru_width)).astype(np.float32)
    want, want_h = ref_rglru.rg_lru_step(rp, jnp.asarray(x1), jnp.asarray(h))
    got, got_h = rglru.rg_lru_step(p, _t(x1), _t(h))
    close_to_scale(got.numpy(), np.asarray(want), 1e-6, "step")
    close_to_scale(got_h.numpy(), np.asarray(want_h), 1e-6, "step h")
    xd = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    state = {"conv": rng.normal(size=(2, 3, cfg.lru_width)).astype(
        np.float32), "h": h}
    want, want_st = ref_rglru.rglru_block_step(
        rp, jnp.asarray(xd), {k: jnp.asarray(v) for k, v in state.items()})
    got, got_st = rglru.rglru_block_step(
        p, _t(xd), {k: _t(v) for k, v in state.items()})
    close_to_scale(got.numpy(), np.asarray(want), 1e-6, "block step")
    for k in ("conv", "h"):
        close_to_scale(got_st[k].numpy(), np.asarray(want_st[k]), 1e-6, k)


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_matches_reference(hyb, with_state):
    """The full-sequence block from zeros or from a carried state: output
    and state within 2e-6 of the scale."""
    rp, p = _rec_block(hyb)
    cfg = hyb["cfg"]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 23, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = {"conv": rng.normal(size=(2, 3, cfg.lru_width)).astype(
            np.float32),
                 "h": rng.normal(size=(2, cfg.lru_width)).astype(np.float32)}
    want, want_st = jax.jit(ref_rglru.rglru_block)(
        rp, jnp.asarray(x),
        state=None if state is None else {k: jnp.asarray(v)
                                          for k, v in state.items()})
    got, got_st = rglru.rglru_block(
        p, _t(x), state=None if state is None else {k: _t(v) for k, v in
                                                    state.items()})
    close_to_scale(got.numpy(), np.asarray(want), 2e-6, "out")
    for k in ("conv", "h"):
        close_to_scale(got_st[k].numpy(), np.asarray(want_st[k]), 2e-6, k)


def test_softplus_matches_jax_over_the_init_range():
    """softplus as logaddexp(x, 0) is within one f32 ulp of
    jax.nn.softplus over Λ's init range and across torch's threshold
    (20), where torch.nn.functional.softplus would switch to x (measured:
    one element of 158 differs, by one ulp)."""
    x = np.concatenate([np.linspace(-9.5, -3.5, 97),
                        np.linspace(-30, 30, 61)]).astype(np.float32)
    got = rglru._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_array_max_ulp(got, np.asarray(jax.nn.softplus(x)), 1)


# ---------------------------------------------------------------------------
# the window ring
# ---------------------------------------------------------------------------

def test_window_ring_decode_matches_windowed_layer(hyb):
    """Token-by-token ring decode (window 16, 2·16 + 3 tokens: the ring
    wraps twice) equals the windowed full-sequence layer, in the port and
    in the reference (the reference's test_window_ring_cache_decode),
    within 1e-5 of the scale; and the port's equals the reference's."""
    cfg, rcfg = hyb["cfg"], hyb["rcfg"]
    attn_i = cfg.block_pattern.index("attn")
    p = hyb["params"]["layers"][attn_i]["temporal"]
    rp = hyb["rparams"]["layers"][attn_i]["temporal"]
    window = cfg.window_size
    seq = 2 * window + 3
    x = (np.random.default_rng(7).normal(size=(1, seq, cfg.d_model))
         * 0.5).astype(np.float32)
    pos = np.arange(seq)[None]
    full = attention.attention_layer(p, _t(x), torch.from_numpy(pos), cfg,
                                     causal=True, window=window,
                                     backend="naive").numpy()
    rfull = np.asarray(ref_attn.attention_layer(
        rp, jnp.asarray(x), jnp.asarray(pos), rcfg, causal=True,
        window=window, backend="naive"))
    cache = attention.init_kv_cache(cfg, 1, window, "cpu")
    rcache = ref_attn.init_kv_cache(rcfg, 1, window)
    ref_step = jax.jit(lambda x1, c, t: ref_attn.attention_decode(
        rp, x1, c, t, rcfg, window=window))
    outs, routs = [], []
    for t in range(seq):
        o, cache = attention.attention_decode(p, _t(x[:, t:t + 1]), cache, t,
                                              cfg, window=window)
        ro, rcache = ref_step(jnp.asarray(x[:, t:t + 1]), rcache,
                              jnp.asarray(t))
        outs.append(o[:, 0].numpy())
        routs.append(np.asarray(ro[:, 0]))
    dec, rdec = np.stack(outs, 1), np.stack(routs, 1)
    close_to_scale(dec, full, 1e-5, "port ring vs layer")
    close_to_scale(rdec, rfull, 1e-5, "reference ring vs layer")
    close_to_scale(dec, rdec, 1e-5, "port vs reference")
    close_to_scale(cache["k"].numpy(), np.asarray(rcache["k"]), 1e-5, "k")


# ---------------------------------------------------------------------------
# the model: prefill, decode, generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["flash", "naive"])
def test_hybrid_prefill_matches_reference(hyb, backend):
    """The port's prefill by either route against the reference's naive
    and flash (Pallas interpret) routes: logits, every LRU state and every
    ring cache within 2e-5 of their scale (measured ≤ 9e-7)."""
    cfg = hyb["cfg"]
    logits, state = model.prefill(cfg, hyb["params"],
                                  {"tokens": torch.from_numpy(hyb["toks"])},
                                  max_seq=PROMPT + GEN, backend=backend)
    assert logits.shape == (BATCH, PROMPT, cfg.padded_vocab)
    assert isinstance(state, list) and len(state) == cfg.num_layers
    got = convert.flatten_tree(state)
    for ref_backend, (rlogits, rstate) in hyb["ref"].items():
        close_to_scale(logits.numpy(), np.asarray(rlogits), 2e-5,
                        ref_backend)
        want = convert.flatten_tree(to_numpy(rstate))
        assert set(got) == set(want)
        for name, w in want.items():
            assert tuple(got[name].shape) == w.shape, name
            assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name
            close_to_scale(got[name].numpy(), w, 2e-5, name)


def test_hybrid_decode_steps_match_reference(hyb):
    """GEN decode steps from the prefilled state (the ring keeps wrapping):
    every step's logits and the final state within 2e-5 of their scale."""
    cfg, rcfg = hyb["cfg"], hyb["rcfg"]
    _, state = model.prefill(cfg, hyb["params"],
                             {"tokens": torch.from_numpy(hyb["toks"])},
                             max_seq=PROMPT + GEN)
    rstate = hyb["ref"]["naive"][1]
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size,
                                             size=(BATCH, GEN), dtype=np.int32)
    for i in range(GEN):
        nxt = toks[:, i:i + 1]
        logits, state = model.decode_step(cfg, hyb["params"], state,
                                          torch.from_numpy(nxt), PROMPT + i)
        rlogits, rstate = hyb["ref_step"](hyb["rparams"], rstate,
                                          jnp.asarray(nxt),
                                          jnp.asarray(PROMPT + i))
        close_to_scale(logits.numpy(), np.asarray(rlogits), 2e-5, i)
    got = convert.flatten_tree(state)
    for name, want in convert.flatten_tree(to_numpy(rstate)).items():
        close_to_scale(got[name].numpy(), want, 2e-5, name)


def test_hybrid_greedy_generation_matches_reference(hyb):
    """Greedy tokens of the port's generate and serve_requests equal the
    reference's launch.serve.generate; every pick's top-1/top-2 gap is
    above MIN_MARGIN."""
    cfg, params, toks = hyb["cfg"], hyb["params"], hyb["toks"]
    logits, state = model.prefill(cfg, params,
                                  {"tokens": torch.from_numpy(toks)},
                                  max_seq=PROMPT + GEN)
    logits, margin = logits[:, -1:], np.inf
    for i in range(GEN):
        top2 = logits[:, -1, :cfg.vocab_size].topk(2, dim=-1).values
        margin = min(margin, float((top2[:, 0] - top2[:, 1]).min()))
        nxt = logits[:, -1, :cfg.vocab_size].argmax(-1).to(torch.int32)
        logits, state = model.decode_step(cfg, params, state, nxt[:, None],
                                          PROMPT + i)
    assert margin > MIN_MARGIN, margin
    want = np.asarray(jax.jit(lambda p, t: ref_generate(
        hyb["rcfg"], p, t, gen_tokens=GEN))(hyb["rparams"], jnp.asarray(toks)))
    got = generate(cfg, params, torch.from_numpy(toks), gen_tokens=GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    out, stats = serve_requests(cfg, params, lambda i: torch.from_numpy(toks),
                                num_requests=2, prompt_len=PROMPT,
                                gen_tokens=GEN)
    np.testing.assert_array_equal(out.numpy(), want)
    assert stats["logits_finite"] == [True, True]


def test_recurrent_prefill_then_decode_equals_decode_all(hyb):
    """prefill(prompt) + decode(GEN more) equals decode(everything) from
    the zero state (the reference's test_recurrent_prefill_matches_decode),
    past two wraps of the ring, at every one of the GEN steps: logits
    within 2e-5 of their scale. (The reference's prefill and decode steps
    are held to the port's by the two tests above.)"""
    cfg, params = hyb["cfg"], hyb["params"]
    extra = np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(BATCH, GEN)).astype(np.int32)
    toks = torch.from_numpy(np.concatenate([hyb["toks"], extra], 1))
    state = model.init_cache(cfg, BATCH, PROMPT + GEN, "cpu")
    want = []
    for t in range(PROMPT + GEN):
        lg, state = model.decode_step(cfg, params, state, toks[:, t:t + 1], t)
        want.append(lg)
    _, state = model.prefill(cfg, params, {"tokens": toks[:, :PROMPT]},
                             max_seq=PROMPT + GEN)
    for t in range(PROMPT, PROMPT + GEN):
        lg, state = model.decode_step(cfg, params, state, toks[:, t:t + 1], t)
        close_to_scale(lg.numpy(), want[t].numpy(), 2e-5, t)


def test_hybrid_init_matches_reference_layout():
    """The port's random init has the reference's tree (a list of
    per-layer dicts), shapes and dtypes (bf16, the f32 `lambda`); its
    decode state too."""
    rcfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    # shapes and dtypes only: traced, not computed
    want = convert.flatten_tree(jax.eval_shape(
        lambda k: ref_model.init_params(rcfg, k), jax.random.PRNGKey(0)))
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert isinstance(params["layers"], list)
    got = convert.flatten_tree(params)
    assert set(got) == set(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name
    assert got["layers.0.temporal.lambda"].dtype == torch.float32
    want = convert.flatten_tree(jax.eval_shape(
        lambda: ref_model.init_cache(rcfg, 2, 50)))
    got = convert.flatten_tree(model.init_cache(cfg, 2, 50, "cpu"))
    assert {n: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for n, t in got.items()} == \
        {n: (a.shape, str(a.dtype)) for n, a in want.items()}
