"""The port's audio family (whisper-base: a bidirectional encoder over the
stub frames, a causal decoder with cross-attention) against the JAX
reference, at the reduced config in float32: the encoder, the
teacher-forced forward by both of the reference's routes (the non-causal
flash route, and cross-attention with Sq ≠ Skv), prefill and its cache,
decode steps, greedy generation, and the zero self-cache the prefill
leaves in both packages.

The same weights (the reference's init, carried across by
`convert.params_from_reference`) and the same numpy frames and tokens go
to both packages. The reference's Pallas flash kernel runs in interpret
mode; the port's "flash" route takes the plain version on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.serve import generate as ref_generate
from repro.models import encdec as ref_encdec
from repro.models import model as ref_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.serve import generate, serve_requests, serving_batch
from repro_torch.models import encdec, model

from test_torch_support import close_to_scale, to_numpy

ARCH = "whisper-base"
PROMPT, GEN, BATCH = 24, 6, 2
MIN_MARGIN = 1e-4      # the greedy picks' top-1/top-2 gap (as test_torch_serve)


@pytest.fixture(scope="module")
def wsp():
    """Reduced f32 whisper in both packages (the reference's weights),
    random frames, a prompt batch, and the reference's prefill by both
    routes."""
    rcfg = dataclasses.replace(ref_get_config(ARCH).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    assert (cfg.encoder_layers, cfg.encoder_seq, cfg.num_layers) == (2, 32, 2)
    rparams = jax.jit(lambda k: ref_model.init_params(rcfg, k))(
        jax.random.PRNGKey(0))
    params = convert.params_from_reference(to_numpy(rparams), device="cpu",
                                           family=cfg.family)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size,
                        size=(BATCH, PROMPT)).astype(np.int32)
    frames = rng.normal(size=(BATCH, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    batch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    ref_out = {backend: jax.jit(
        lambda p, b, backend=backend: ref_model.prefill(
            rcfg, p, b, max_seq=PROMPT + GEN, backend=backend))(
                rparams, batch)
        for backend in ("naive", "flash")}
    ref_step = jax.jit(lambda p, c, t, pos: ref_model.decode_step(
        rcfg, p, c, t, pos))
    return dict(rcfg=rcfg, cfg=cfg, rparams=rparams, params=params,
                toks=toks, frames=frames, ref=ref_out, ref_step=ref_step)


def _batch(wsp):
    return {"tokens": torch.from_numpy(wsp["toks"]),
            "frames": torch.from_numpy(wsp["frames"])}


@pytest.mark.parametrize("backend", ["flash", "naive"])
def test_encode_matches_reference(wsp, backend):
    """The encoder (non-causal attention at every layer) by either route
    against the reference's naive route: within 2e-5 of the scale."""
    got = encdec.encode(wsp["params"], torch.from_numpy(wsp["frames"]),
                        wsp["cfg"], backend=backend)
    want = ref_encdec.encode(wsp["rparams"], jnp.asarray(wsp["frames"]),
                             wsp["rcfg"], backend="naive")
    close_to_scale(got.numpy(), np.asarray(want), 2e-5)


@pytest.mark.parametrize("backend", ["flash", "naive"])
def test_encdec_prefill_matches_reference(wsp, backend):
    """The port's prefill by either route against the reference's naive
    and flash (Pallas interpret: the non-causal encoder, the causal
    decoder, the S × Se cross-attention) routes: logits and the cache
    (cross k/v, the zero self-cache) within 2e-5 of their scale (measured
    ≤ 9e-7)."""
    cfg = wsp["cfg"]
    logits, cache = model.prefill(cfg, wsp["params"], _batch(wsp),
                                  max_seq=PROMPT + GEN, backend=backend)
    assert logits.shape == (BATCH, PROMPT, cfg.padded_vocab)
    got = convert.flatten_tree(cache)
    for ref_backend, (rlogits, rcache) in wsp["ref"].items():
        close_to_scale(logits.numpy(), np.asarray(rlogits), 2e-5,
                        ref_backend)
        want = convert.flatten_tree(to_numpy(rcache))
        assert set(got) == set(want)
        for name, w in want.items():
            assert tuple(got[name].shape) == w.shape, name
            close_to_scale(got[name].numpy(), w, 2e-5, name)


def test_prefill_leaves_a_zero_self_cache_in_both_packages(wsp):
    """The reference's audio prefill returns `init_encdec_cache`, whose
    decoder self-cache is zeros (only the logits come from
    `encdec_forward`), so decoding from position S attends over S zero
    slots; the port reproduces it (ROADMAP §3, reference conditions). The
    first decode step then agrees within 2e-5, and differs from one on a
    self-cache filled by decoding the prompt."""
    cfg, rcfg = wsp["cfg"], wsp["rcfg"]
    _, cache = model.prefill(cfg, wsp["params"], _batch(wsp),
                             max_seq=PROMPT + GEN)
    rcache = wsp["ref"]["naive"][1]
    for name in ("k", "v"):
        assert not cache["self"][name].any()
        assert not np.asarray(rcache["self"][name]).any()
        assert cache["cross"][name].abs().max() > 0
    nxt = np.array([[5], [cfg.vocab_size - 1]], np.int32)
    lg, _ = model.decode_step(cfg, wsp["params"], cache,
                              torch.from_numpy(nxt), PROMPT)
    rlg, _ = wsp["ref_step"](wsp["rparams"], rcache, jnp.asarray(nxt),
                             jnp.asarray(PROMPT))
    close_to_scale(lg.numpy(), np.asarray(rlg), 2e-5)
    # a self-cache filled by decoding the prompt gives other logits
    _, filled = model.prefill(cfg, wsp["params"], _batch(wsp),
                              max_seq=PROMPT + GEN)
    toks = torch.from_numpy(wsp["toks"])
    for t in range(PROMPT):
        _, filled = model.decode_step(cfg, wsp["params"], filled,
                                      toks[:, t:t + 1], t)
    lg_filled, _ = model.decode_step(cfg, wsp["params"], filled,
                                     torch.from_numpy(nxt), PROMPT)
    assert float((lg_filled - lg).abs().max()) > 1e-3


def test_encdec_decode_steps_match_reference(wsp):
    """GEN decode steps from the prefilled cache: every step's logits and
    the final cache (self-cache written in place) within 2e-5 of their
    scale."""
    cfg, rcfg = wsp["cfg"], wsp["rcfg"]
    _, cache = model.prefill(cfg, wsp["params"], _batch(wsp),
                             max_seq=PROMPT + GEN)
    rcache = wsp["ref"]["naive"][1]
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             size=(BATCH, GEN), dtype=np.int32)
    for i in range(GEN):
        nxt = toks[:, i:i + 1]
        logits, cache = model.decode_step(cfg, wsp["params"], cache,
                                          torch.from_numpy(nxt), PROMPT + i)
        rlogits, rcache = wsp["ref_step"](wsp["rparams"], rcache,
                                          jnp.asarray(nxt),
                                          jnp.asarray(PROMPT + i))
        close_to_scale(logits.numpy(), np.asarray(rlogits), 2e-5, i)
    got = convert.flatten_tree(cache)
    for name, want in convert.flatten_tree(to_numpy(rcache)).items():
        close_to_scale(got[name].numpy(), want, 2e-5, name)


def test_encdec_greedy_generation_matches_reference(wsp):
    """Greedy tokens of the port's generate and serve_requests (the
    driver's zero frames, `serving_batch`) equal the reference's
    launch.serve.generate (its own zero frames); every pick's top-1/top-2
    gap is above MIN_MARGIN."""
    cfg, params, toks = wsp["cfg"], wsp["params"], wsp["toks"]
    prompts = torch.from_numpy(toks)
    batch = serving_batch(cfg, prompts)
    assert batch["frames"].shape == (BATCH, cfg.encoder_seq, cfg.d_model)
    assert batch["frames"].dtype == torch.float32
    assert not batch["frames"].any()
    logits, cache = model.prefill(cfg, params, batch, max_seq=PROMPT + GEN)
    logits, margin = logits[:, -1:], np.inf
    for i in range(GEN):
        top2 = logits[:, -1, :cfg.vocab_size].topk(2, dim=-1).values
        margin = min(margin, float((top2[:, 0] - top2[:, 1]).min()))
        nxt = logits[:, -1, :cfg.vocab_size].argmax(-1).to(torch.int32)
        logits, cache = model.decode_step(cfg, params, cache, nxt[:, None],
                                          PROMPT + i)
    assert margin > MIN_MARGIN, margin
    want = np.asarray(jax.jit(lambda p, t: ref_generate(
        wsp["rcfg"], p, t, gen_tokens=GEN))(wsp["rparams"], jnp.asarray(toks)))
    np.testing.assert_array_equal(
        generate(cfg, params, prompts, gen_tokens=GEN).numpy(), want)
    out, stats = serve_requests(cfg, params, lambda i: prompts,
                                num_requests=2, prompt_len=PROMPT,
                                gen_tokens=GEN)
    np.testing.assert_array_equal(out.numpy(), want)
    assert stats["logits_finite"] == [True, True]


def test_encdec_init_matches_reference_layout():
    """The port's random init has the reference's tree (stacked encoder
    and decoder layers), shapes and dtypes; init_cache the reference's
    skeleton."""
    rcfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    # shapes and dtypes only: traced, not computed
    want = convert.flatten_tree(jax.eval_shape(
        lambda k: ref_model.init_params(rcfg, k), jax.random.PRNGKey(0)))
    got = convert.flatten_tree(model.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    assert set(got) == set(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name
    want = convert.flatten_tree(jax.eval_shape(
        lambda: ref_model.init_cache(rcfg, 2, 50)))
    got = convert.flatten_tree(model.init_cache(cfg, 2, 50, "cpu"))
    assert {n: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for n, t in got.items()} == \
        {n: (a.shape, str(a.dtype)) for n, a in want.items()}
