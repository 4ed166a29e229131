"""The port's serving path against the JAX reference: the plain versions
of the two serving kernels (flash_attention, wkv_chunked), the LLM layers,
the "chunked" attention backend, prefill, decode and greedy generation of
qwen2-1.5b, starcoder2-7b and rwkv6-7b (reduced configs, float32), the
configs and their parameter counts, and `convert` on LLM trees.

The same numpy inputs, made from a seed, go to both packages. The
reference's Pallas kernels run in interpret mode, as its own tests run
them on the CPU; its models run both the "naive" and the "flash" route.
On the CPU the port's "flash" route takes the plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_REGISTRY as REF_REGISTRY
from repro.configs import get_config as ref_get_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.wkv_chunked import wkv_chunked as pallas_wkv
from repro.launch.serve import generate as ref_generate
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro_torch import convert
from repro_torch.configs import ARCH_REGISTRY, ModelConfig, get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.wkv_chunked import wkv_chunked_plain
from repro_torch.launch.serve import generate, serve_requests
from repro_torch.models import attention, layers, model, rwkv

from test_torch_support import to_numpy

PROMPT, GEN, BATCH = 80, 8, 2
# Greedy tokens are compared exactly; the port's f32 logits differ from
# the reference's by ~1e-6 (see test_prefill_matches_reference), so every
# decode step's top-1/top-2 logit gap must exceed this for the comparison
# to be meaningful.
MIN_MARGIN = 1e-4


def _torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close_to_scale(got, want, rel, what=""):
    """max |got − want| ≤ rel · max(1, max |want|) (float32 numpy)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _one_ulp(got, want):
    """bf16 outputs within one bf16 ulp of each other plus 1e-5 of the
    scale (both routes compute in f32 and round once: a rounding boundary,
    or the f32 error of a value that cancelled to near zero, is all that
    differs)."""
    assert ref.within_ulps(_torch(got, torch.bfloat16),
                           _torch(want, torch.bfloat16))


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

# (B, Sq, Skv, H, K, hd, causal, window, q_offset)
FLASH_CASES = [
    (2, 200, 200, 12, 2, 128, True, 0, 0),     # qwen2's GQA (rep 6), ragged
    (1, 77, 130, 4, 4, 64, True, 16, 53),      # rep 1, window + q_offset
    (1, 50, 90, 6, 3, 64, False, 0, 0),        # rep 2, not causal
    (2, 130, 130, 4, 2, 128, True, 0, 0),      # rep 2, hd 128
    (1, 33, 160, 6, 1, 128, True, 0, 127),     # a continuation chunk
    (1, 64, 64, 2, 2, 64, True, 24, 0),        # window, whole blocks
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "b{}-q{}-kv{}-h{}-k{}-d{}-c{}-w{}-o{}"
                         .format(*(int(x) for x in c)))
def test_flash_attention_plain_matches_pallas_and_oracle(case, dtype):
    """f32: within 1e-5 of the output's scale (measured ≤ 1.4e-6); bf16:
    within one bf16 ulp of the Pallas kernel and of the oracle."""
    b, sq, skv, h, kh, hd, causal, window, q_offset = case
    rng = np.random.default_rng(sum(case))
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, kh, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, kh, hd)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want_pallas = pallas_flash(jq, jk, jv, interpret=True, **kw)
    want_ref = jref.flash_attention_ref(jq, jk, jv, **kw)
    got = flash_attention_plain(_torch(q, tdt), _torch(k, tdt),
                                _torch(v, tdt), **kw)
    assert got.dtype == tdt and got.shape == (b, sq, h, hd)
    got = got.float().numpy()
    for want in (want_pallas, want_ref):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            _close_to_scale(got, want, 1e-5)
        else:
            _one_ulp(got, want)
    # the port's own oracle agrees with the reference's
    port_ref = ref.flash_attention_ref(_torch(q, tdt), _torch(k, tdt),
                                       _torch(v, tdt), **kw).float().numpy()
    if dtype == "float32":
        _close_to_scale(port_ref, np.asarray(want_ref), 1e-5)


# (B, Sq, Skv, H, K, hd, causal, window, q_offset): hd off the kernel's
# instances (padded to 64, 128 or 256) and at 256 (recurrentgemma-2b)
FLASH_PAD_CASES = [
    (1, 40, 40, 2, 1, 8, True, 0, 0),
    (1, 77, 130, 4, 4, 96, True, 16, 53),
    (2, 50, 90, 4, 2, 200, False, 0, 0),
    (1, 140, 140, 2, 1, 256, True, 64, 0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_PAD_CASES,
                         ids=lambda c: "b{}-q{}-kv{}-h{}-k{}-d{}-c{}-w{}-o{}"
                         .format(*(int(x) for x in c)))
def test_flash_attention_padded_route_equals_unpadded(case, dtype):
    """The route the CUDA wrapper takes for a head dim between the kernel
    instances — q, k, v zero-padded to the next instance, the scale of
    the true head dim, the padded columns dropped — through the plain
    version equals the plain version on the unpadded inputs: f32 within
    1e-6 of max(1, max|out|), bf16 within one bf16 ulp; and the Pallas
    kernel (any hd) within 1e-5 (f32) or one ulp (bf16)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_padded, padded_head_dim)

    b, sq, skv, h, kh, hd, causal, window, q_offset = case
    rng = np.random.default_rng(sum(case))
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, kh, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, kh, hd)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    tq, tk, tv = (_torch(a, tdt) for a in (q, k, v))
    seen = []

    def plain(*args, **kwargs):
        seen.append(args[0].shape[-1])
        return flash_attention_plain(*args, **kwargs)

    got = flash_attention_padded(plain, tq, tk, tv, **kw)
    assert seen == [padded_head_dim(hd)] and got.shape == (b, sq, h, hd)
    assert got.dtype == tdt
    want = flash_attention_plain(tq, tk, tv, **kw)
    pallas = np.asarray(pallas_flash(*(jnp.asarray(a, jdt) for a in
                                       (q, k, v)), interpret=True,
                                     **kw).astype(jnp.float32))
    if dtype == "float32":
        _close_to_scale(got.numpy(), want.numpy(), 1e-6)
        _close_to_scale(got.numpy(), pallas, 1e-5)
    else:
        _one_ulp(got.float().numpy(), want.float().numpy())
        _one_ulp(got.float().numpy(), pallas)


def test_flash_attention_head_dims_past_256_raise():
    from repro_torch.kernels.flash_attention import padded_head_dim

    assert [padded_head_dim(d) for d in (1, 64, 65, 128, 129, 256)] == \
        [64, 64, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="up to 256"):
        padded_head_dim(257)


def test_flash_attention_plain_fully_masked_rows_are_zero():
    """A window and offset that hide every key from the first rows: the
    online softmax keeps p = 0 and l floored, so those rows are 0, as in
    the Pallas kernel."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(1, 16, 2, 64)).astype(np.float32)
               for _ in range(3))
    kw = dict(causal=True, window=4, q_offset=-8)
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                **kw).numpy()
    want = np.asarray(pallas_flash(*(jnp.asarray(a) for a in (q, k, v)),
                                   interpret=True, **kw))
    assert np.all(got[:, :8] == 0) and np.all(want[:, :8] == 0)
    _close_to_scale(got, want, 1e-5)


# ---------------------------------------------------------------------------
# wkv_chunked
# ---------------------------------------------------------------------------

# (B, S, H, dtype of r/k/v, initial state, lowest log-log decay)
WKV_CASES = [
    (2, 150, 3, "float32", True, 1.0),    # ragged, strong decay (w ≥ 0.066)
    (1, 37, 2, "float32", False, -1.0),   # one short chunk, no state
    (1, 128, 2, "bfloat16", True, -1.0),  # the serving dtype
    (1, 5, 2, "float32", True, 1.0),      # S < 8: the Pallas chunk is 8
]


def _wkv_inputs(b, s, h, state, hi, seed, hd=64):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-6.0, hi, size=(b, s, h, hd)))).astype(
        np.float32)
    u = (rng.normal(size=(h, hd)) * 0.3).astype(np.float32)
    s0 = rng.normal(size=(b, h, hd, hd)).astype(np.float32) if state \
        else None
    return r, k, v, w, u, s0


@pytest.mark.parametrize("case", WKV_CASES,
                         ids=lambda c: "b{}-s{}-h{}-{}-state{}-hi{}".format(
                             *c))
def test_wkv_chunked_plain_matches_pallas_and_oracle(case):
    """Output within 1e-5 of its scale at f32 (measured ≤ 1.3e-6), within
    one bf16 ulp at bf16; final state within 1e-5 of its scale."""
    b, s, h, dtype, state, hi = case
    r, k, v, w, u, s0 = _wkv_inputs(b, s, h, state, hi, seed=s + h)
    bf16 = dtype == "bfloat16"
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jr, jk, jv = (jnp.asarray(a, jdt) for a in (r, k, v))
    js0 = None if s0 is None else jnp.asarray(s0)
    wants = [pallas_wkv(jr, jk, jv, jnp.asarray(w), jnp.asarray(u), js0,
                        interpret=True),
             jref.wkv_ref(jr, jk, jv, jnp.asarray(w), jnp.asarray(u), js0)]
    got, got_s = wkv_chunked_plain(
        _torch(r, tdt), _torch(k, tdt), _torch(v, tdt), torch.from_numpy(w),
        torch.from_numpy(u), None if s0 is None else torch.from_numpy(s0))
    assert got.dtype == tdt and got_s.dtype == torch.float32
    for want, want_s in wants:
        want = np.asarray(want.astype(jnp.float32))
        if bf16:
            _one_ulp(got.float().numpy(), want)
        else:
            _close_to_scale(got.numpy(), want, 1e-5, "out")
        _close_to_scale(got_s.numpy(), np.asarray(want_s), 1e-5, "state")
    # the port's per-token oracle agrees with the reference's
    po, ps = ref.wkv_ref(_torch(r, tdt), _torch(k, tdt), _torch(v, tdt),
                         torch.from_numpy(w), torch.from_numpy(u),
                         None if s0 is None else torch.from_numpy(s0))
    _close_to_scale(ps.numpy(), np.asarray(wants[1][1]), 1e-5, "oracle")
    if not bf16:
        _close_to_scale(po.numpy(), np.asarray(wants[1][0]), 1e-5, "oracle")


def test_wkv_plain_state_carries_across_calls():
    """Two calls chained through the state equal one call over the whole
    sequence (the property prefill-then-decode relies on)."""
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in
                         _wkv_inputs(1, 100, 2, True, 0.0, seed=9))
    whole, s_whole = wkv_chunked_plain(r, k, v, w, u, s0)
    a, s_a = wkv_chunked_plain(r[:, :70], k[:, :70], v[:, :70], w[:, :70],
                               u, s0)
    bb, s_b = wkv_chunked_plain(r[:, 70:], k[:, 70:], v[:, 70:], w[:, 70:],
                                u, s_a)
    _close_to_scale(torch.cat([a, bb], 1).numpy(), whole.numpy(), 1e-5)
    _close_to_scale(s_b.numpy(), s_whole.numpy(), 1e-5)


def test_serving_cuda_wrappers_refuse_cpu_tensors():
    """Both kernel wrappers check their inputs before any build or launch,
    and impl='cuda' on a CPU tensor raises (the plain-route launch counts
    are held by test_torch_kernels.test_plain_route_counts_no_launches)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.wkv_chunked import wkv_chunked_cuda

    q = torch.randn(1, 9, 2, 64)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in
                         _wkv_inputs(1, 9, 2, True, 0.0, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_chunked_cuda(r, k, v, w, u, s0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv(r, k, v, w, u, s0, impl="cuda")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llm_layers_match_reference(dtype):
    """rms_norm, apply_rope and the gated MLP. f32: rtol 1e-5 (sums in
    another order); bf16: within 2 bf16 ulps (rms_norm, rope: the same
    roundings of f32 values, one ulp per rounding at a boundary) and 2e-2
    of the scale for the MLP (three bf16 products with f32 accumulation)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    scale = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    heads = rng.normal(size=(2, 9, 4, 64)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32) + 3
    mlp_p = {n: (rng.normal(size=shape) * 0.1).astype(np.float32)
             for n, shape in (("wi", (64, 96)), ("wg", (64, 96)),
                              ("wo", (96, 64)))}
    bf16 = dtype == "bfloat16"
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    J = lambda a: jnp.asarray(a, jdt)          # noqa: E731
    T = lambda a: _torch(a, tdt)               # noqa: E731
    pairs = [
        (layers.rms_norm(T(x), T(scale), 1e-6),
         ref_layers.rms_norm(J(x), J(scale), 1e-6)),
        (layers.apply_rope(T(heads), torch.from_numpy(pos), 1e6),
         ref_layers.apply_rope(J(heads), jnp.asarray(pos), 1e6)),
    ]
    for got, want in pairs:
        assert got.dtype == tdt
        want = np.asarray(want.astype(jnp.float32))
        if bf16:
            assert ref.within_ulps(got, _torch(want, torch.bfloat16), 2)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6)
    got = layers.mlp({n: T(a) for n, a in mlp_p.items()}, T(x))
    want = ref_layers.mlp({n: J(a) for n, a in mlp_p.items()}, J(x))
    _close_to_scale(got.float().numpy(),
                    np.asarray(want.astype(jnp.float32)),
                    2e-2 if bf16 else 1e-5)


def test_apply_rope_makes_frequencies_once_per_device():
    """The inverse frequencies are made and copied once per (head_dim,
    theta, device), not at every call: on a card each copy from host
    memory would wait on the card, at every layer of every decode step."""
    x = torch.ones((1, 3, 2, 32))
    pos = torch.arange(3)
    layers.apply_rope(x, pos, 12345.0)
    before = layers._inv_freq_on.cache_info()
    layers.apply_rope(x, pos + 1, 12345.0)
    after = layers._inv_freq_on.cache_info()
    assert (after.misses, after.hits) == (before.misses, before.hits + 1)
    assert torch.equal(layers._inv_freq_on(32, 12345.0, x.device),
                       layers.rope_frequencies(32, 12345.0))


# ---------------------------------------------------------------------------
# the models: prefill, decode, generation
# ---------------------------------------------------------------------------

ARCHS = ["qwen2-1.5b", "starcoder2-7b", "rwkv6-7b"]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One reduced f32 model in both packages, a prompt batch, and the
    reference's prefill by both of its routes."""
    arch = request.param
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    rparams = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
    params = convert.params_from_reference(to_numpy(rparams), device="cpu",
                                           family=cfg.family)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT)).astype(np.int32)
    ref_out = {
        backend: ref_model.prefill(rcfg, rparams,
                                   {"tokens": jnp.asarray(toks)},
                                   max_seq=PROMPT + GEN, backend=backend)
        for backend in ("naive", "flash")}
    return dict(arch=arch, rcfg=rcfg, cfg=cfg, rparams=rparams,
                params=params, toks=toks, ref=ref_out)


def test_reduced_configs_match_reference():
    """Every registered config and its reduced() equal the reference's,
    field by field, with the same derived properties."""
    for arch in ARCH_REGISTRY:
        want = ref_get_config(arch)
        for cfg, rcfg in ((get_config(arch), want),
                          (get_config(arch).reduced(), want.reduced())):
            names = [f.name for f in dataclasses.fields(cfg)]
            assert sorted(names) == sorted(f.name for f in
                                           dataclasses.fields(rcfg))
            for name in names:
                assert getattr(cfg, name) == getattr(rcfg, name), \
                    (arch, name)
            for prop in ("padded_vocab", "n_rep", "is_attention_free",
                         "sub_quadratic"):
                assert getattr(cfg, prop) == getattr(rcfg, prop), \
                    (arch, prop)


def _port_config(rcfg):
    """The port's ModelConfig built from a reference config's fields."""
    return ModelConfig(**{f.name: getattr(rcfg, f.name)
                          for f in dataclasses.fields(rcfg)})


@pytest.mark.parametrize("arch", sorted(REF_REGISTRY))
def test_param_counts_match_reference(arch):
    """count_params, param_count and active_param_count (every family's
    branch, MLA and experts included) equal the reference's for all of
    its configs, full and reduced, built from the reference's fields."""
    for rcfg in (REF_REGISTRY[arch], REF_REGISTRY[arch].reduced()):
        cfg = _port_config(rcfg)
        assert model.count_params(cfg) == ref_model.count_params(rcfg)
        assert model.count_params(cfg, active_only=True) == \
            ref_model.count_params(rcfg, active_only=True)
        assert cfg.param_count() == rcfg.param_count()
        assert cfg.active_param_count() == rcfg.active_param_count()


# (B, Sq, Skv, H, K, hd, causal, window, q_offset): several 1024 blocks,
# ragged ends (padding), a window, a continuation chunk, not causal
CHUNKED_CASES = [
    (1, 2500, 2500, 4, 2, 16, True, 0, 0),
    (1, 2500, 2500, 2, 1, 16, True, 700, 0),
    (1, 1400, 2600, 2, 2, 16, True, 300, 1200),
    (1, 1100, 2100, 2, 1, 16, False, 0, 0),
]


@pytest.mark.parametrize("case", CHUNKED_CASES,
                         ids=lambda c: "q{}-kv{}-h{}-k{}-c{}-w{}-o{}".format(
                             *(int(x) for x in c[1:5] + c[6:])))
def test_chunked_attention_matches_reference(case):
    """attend(backend="chunked") — the reference's static block schedule,
    online softmax and clamps — against the reference's and against the
    naive route: f32 within 1e-5 of the output's scale."""
    b, sq, skv, h, kh, hd, causal, window, q_offset = case
    rng = np.random.default_rng(sum(case))
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, kh, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, kh, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = attention.attend(*(torch.from_numpy(a) for a in (q, k, v)),
                           backend="chunked", **kw)
    assert got.shape == (b, sq, h, hd) and got.dtype == torch.float32
    want = ref_attention.attend(*(jnp.asarray(a) for a in (q, k, v)),
                                backend="chunked", **kw)
    _close_to_scale(got.numpy(), np.asarray(want), 1e-5, "reference")
    naive = attention.attend(*(torch.from_numpy(a) for a in (q, k, v)),
                             backend="naive", **kw)
    _close_to_scale(got.numpy(), naive.numpy(), 1e-5, "naive")


@pytest.mark.parametrize("backend", ["flash", "naive"])
def test_prefill_matches_reference(served, backend):
    """The port's prefill by either route (flash: the plain kernels on the
    CPU; naive: materialized scores / the per-token recurrence) against
    the reference's naive and flash (Pallas interpret) routes: logits
    within 2e-5 of their scale (measured ≤ 2.2e-6 at scale ~1.4), the KV
    cache at the filled positions (zeros after) or the rwkv decode state
    within 2e-5 of its scale."""
    cfg = served["cfg"]
    logits, cache = model.prefill(
        cfg, served["params"], {"tokens": torch.from_numpy(served["toks"])},
        max_seq=PROMPT + GEN, backend=backend)
    assert logits.shape == (BATCH, PROMPT, cfg.padded_vocab)
    got_cache = convert.flatten_tree(cache)
    for ref_backend, (rlogits, rcache) in served["ref"].items():
        _close_to_scale(logits.numpy(), np.asarray(rlogits), 2e-5,
                        ref_backend)
        want_cache = convert.flatten_tree(to_numpy(rcache))
        assert set(got_cache) == set(want_cache)
        for name, want in want_cache.items():
            got = got_cache[name].numpy()
            assert got.shape == want.shape, name
            _close_to_scale(got, want, 2e-5, name)
    if cfg.family == "dense":
        assert np.all(got_cache["k"][:, :, PROMPT:].numpy() == 0)


def test_decode_step_matches_reference(served):
    """One decode step from the prefilled cache: logits within 2e-5 of
    their scale, and the cache (dense, written in place) or state (rwkv)
    within 2e-5."""
    cfg, rcfg = served["cfg"], served["rcfg"]
    _, cache = model.prefill(cfg, served["params"],
                             {"tokens": torch.from_numpy(served["toks"])},
                             max_seq=PROMPT + GEN)
    nxt = np.array([[3], [cfg.vocab_size - 1]], np.int32)
    logits, cache = model.decode_step(cfg, served["params"], cache,
                                      torch.from_numpy(nxt), PROMPT)
    rlogits, rcache = ref_model.decode_step(
        rcfg, served["rparams"], served["ref"]["naive"][1], jnp.asarray(nxt),
        jnp.asarray(PROMPT))
    assert logits.shape == (BATCH, 1, cfg.padded_vocab)
    _close_to_scale(logits.numpy(), np.asarray(rlogits), 2e-5, "logits")
    got = convert.flatten_tree(cache)
    for name, want in convert.flatten_tree(to_numpy(rcache)).items():
        _close_to_scale(got[name].numpy(), want, 2e-5, name)


def _greedy_margins(cfg, params, toks):
    """The port's greedy decode run by hand: the smallest top-1/top-2 gap
    of the (unpadded) logits over the GEN picks, and the tokens."""
    logits, cache = model.prefill(cfg, params,
                                  {"tokens": torch.from_numpy(toks)},
                                  max_seq=PROMPT + GEN)
    logits = logits[:, -1:].float()
    margin, picked = np.inf, []
    for i in range(GEN):
        top2 = logits[:, -1, :cfg.vocab_size].topk(2, dim=-1).values
        margin = min(margin, float((top2[:, 0] - top2[:, 1]).min()))
        nxt = logits[:, -1, :cfg.vocab_size].argmax(-1).to(torch.int32)
        picked.append(nxt)
        logits, cache = model.decode_step(cfg, params, cache, nxt[:, None],
                                          PROMPT + i)
    return margin, torch.stack(picked, 1).numpy()


def test_greedy_generation_matches_reference(served):
    """Greedy tokens of the port's generate and serve_requests equal the
    reference's launch.serve.generate, with every pick's top-1/top-2 gap
    above MIN_MARGIN (100× the logit differences measured above)."""
    cfg, params, toks = served["cfg"], served["params"], served["toks"]
    margin, picked = _greedy_margins(cfg, params, toks)
    assert margin > MIN_MARGIN, margin
    want = np.asarray(ref_generate(served["rcfg"], served["rparams"],
                                   jnp.asarray(toks), gen_tokens=GEN))
    got = generate(cfg, params, torch.from_numpy(toks), gen_tokens=GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(picked, want[:, PROMPT:])
    out, stats = serve_requests(
        cfg, params, lambda i: torch.from_numpy(toks), num_requests=2,
        prompt_len=PROMPT, gen_tokens=GEN)
    np.testing.assert_array_equal(out.numpy(), want)
    assert stats["logits_finite"] == [True, True]
    assert set(stats["stages"]) == {"prefill", "decode"}
    assert stats["stages"]["decode"]["calls"] == 2
    assert len(stats["requests"]) == 2


def test_sampled_generation_stays_in_vocab(served):
    """greedy=False draws from the port's generator: reproducible from a
    seed, never a padded-vocabulary token."""
    cfg, params = served["cfg"], served["params"]
    toks = torch.from_numpy(served["toks"])
    draws = [generate(cfg, params, toks, gen_tokens=GEN, greedy=False,
                      generator=torch.Generator().manual_seed(5))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    new = draws[0][:, PROMPT:]
    assert int(new.min()) >= 0 and int(new.max()) < cfg.vocab_size


def test_serve_main_runs_on_cpu(tmp_path, capsys):
    out_json = tmp_path / "lat.json"
    out = __import__("repro_torch.launch.serve", fromlist=["main"]).main(
        ["--arch", "rwkv6-7b", "--reduced", "--device", "cpu", "--batch",
         "2", "--prompt-len", "12", "--gen", "3", "--requests", "2",
         "--latency-out", str(out_json)])
    assert out.shape == (2, 15)
    assert "steady request latency" in capsys.readouterr().out
    assert out_json.exists()


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-base",
                                  "qwen2.5-3b"])
def test_serve_main_runs_new_archs_on_cpu(arch, capsys):
    """The driver serves the hybrid and audio families (whisper from the
    driver's zero frames) and a qwen2.5 config, reduced, on the CPU; the
    prompt (20) wraps recurrentgemma's reduced window (16)."""
    out = __import__("repro_torch.launch.serve", fromlist=["main"]).main(
        ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "20", "--gen", "3", "--requests", "2"])
    assert out.shape == (2, 23)
    assert int(out.max()) < get_config(arch).reduced().vocab_size
    assert f"arch={arch}-smoke" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# convert, and what is not ported
# ---------------------------------------------------------------------------

def test_llm_tree_round_trips_without_transpose():
    """An LLM tree — even one whose leaves carry the cnn's conv names —
    keeps every leaf's layout through convert; a cnn tree still gets its
    HWIO conv leaves as OIHW."""
    rng = np.random.default_rng(0)
    tree = {"layers": {"attn": {"wq": rng.normal(size=(2, 8, 16))},
                       "proj": rng.normal(size=(2, 3, 4, 5)),
                       "conv": rng.normal(size=(3, 3, 4, 6))},
            "lm_head": rng.normal(size=(8, 32))}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    for family in ("dense", "ssm"):
        port = convert.params_from_reference(tree, device="cpu",
                                             family=family)
        assert port["layers"]["proj"].shape == (2, 3, 4, 5)
        np.testing.assert_array_equal(port["layers"]["conv"].numpy(),
                                      tree["layers"]["conv"])
        back = convert.params_to_reference(port, family=family)
        for got, want in zip(jax.tree_util.tree_leaves(back),
                             jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(got, want)
    cnn = convert.params_from_reference({"stem": {"conv": tree["layers"][
        "conv"]}}, device="cpu")
    assert cnn["stem.conv"].shape == (6, 4, 3, 3)
    back = convert.params_to_reference(cnn)
    np.testing.assert_array_equal(back["stem"]["conv"],
                                  tree["layers"]["conv"])


def test_init_params_matches_reference_layout():
    """The port's own random init has the reference's tree, shapes and
    dtypes (bf16) for the dense, ssm, moe (with MLA) and vlm families."""
    for arch in ARCHS + ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
                         "internvl2-76b"]:
        rcfg = ref_get_config(arch).reduced()
        want = convert.flatten_tree(jax.jit(
            lambda k: ref_model.init_params(rcfg, k))(jax.random.PRNGKey(0)))
        got = convert.flatten_tree(model.init_params(
            get_config(arch).reduced(), torch.Generator().manual_seed(0),
            "cpu"))
        assert set(got) == set(want), arch
        for name, t in got.items():
            assert tuple(t.shape) == want[name].shape, name
            assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name


def test_unported_families_and_backends_raise():
    """Every LLM family serves and, since LLM training was ported (queue
    1 item 12), trains: `model.forward` and `model.loss_fn` on an LLM
    family return logits and a finite loss, and rwkv's "chunked" prefill
    runs (`wkv_chunked_torch`). The attention backend "chunked" is
    ported (test_chunked_attention_matches_reference); an unknown
    attention or rwkv backend raises."""
    for arch in ("qwen2-1.5b", "phi3.5-moe-42b-a6.6b", "internvl2-76b"):
        cfg = get_config(arch).reduced()
        assert model.init_cache(cfg, 1, 4, "cpu")["k"].shape[2] == 4
        params = model.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        toks = torch.zeros(1, 2, dtype=torch.int64)
        logits, aux = model.forward(cfg, params, {"tokens": toks})
        assert logits.shape[:2] == (1, 2)
        assert set(aux) == {"load_balance", "router_z"}
        total, _ = model.loss_fn(cfg, params, {"tokens": toks})
        assert torch.isfinite(total)
    q = torch.zeros(1, 4, 2, 8)
    assert attention.attend(q, q, q, backend="chunked").shape == q.shape
    with pytest.raises(ValueError, match="unknown attention backend"):
        attention.attend(q, q, q, backend="blocked")
    cfg = get_config("rwkv6-7b").reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros(1, 2, dtype=torch.int32)
    logits, _ = rwkv.rwkv_prefill(params, toks, cfg, backend="chunked")
    assert logits.shape[:2] == (1, 2)
    with pytest.raises(ValueError, match="unknown rwkv backend"):
        rwkv.rwkv_prefill(params, toks, cfg, backend="blocked")
    with pytest.raises(ValueError, match="no decode step"):
        model.init_cache(get_config("resnet18-cifar"), 1, 4, "cpu")
