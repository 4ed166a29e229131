"""The numerics of the port's Hopper kernel designs, held to the JAX
reference on the CPU (its Pallas kernels in interpret mode).

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py). What can be shown here is that their arithmetic meets the
reference's tolerance before chip time is spent on it:

* flash_attention for bf16/f16 inputs (csrc/flash_attention.cu, wgmma
  route): its arithmetic, step for step — S in f32, the row max over the
  unscaled scores, p = 2^(s·(scale·log2 e) − m·log2 e) by an fma with
  results below 2^-126 flushed to 0, each row's sum kept in four
  lane-shares, P·V with p split into a hi part (p rounded to the input
  type) and a lo part (p − hi, rounded), and a reciprocal multiply at
  the end — within one ulp of the Pallas kernel, which multiplies an f32
  p by V. What the CPU cannot reproduce: the SFU's ex2.approx (≤ 2 ulp
  from the exact 2^x used here), the fast reciprocal (≤ 2 ulp) and the
  tensor cores' order of summation inside a wgmma. The kernel's band
  (its first and last kv tile) is the formula written out in Python
  below; that it is the CUDA code's is shown only on the card, where the
  ragged cases hold the kernel to its plain version.
* raw_gram (csrc/raw_gram.cu, split-K): the split plan of
  `peer_score.gram_split_plan`, and partial Grams summed in its order.
* wkv_chunked (csrc/wkv_chunked.cu): the state pass and the output pass
  step for step — decay factors as products of w taken from the
  sub-chunks' edges, the factored off-diagonal sub-blocks, the diagonal
  ones with the decay inside the sum, and every product in 3xTF32 (TF32
  rounding emulated on the f32 bits) — within the card's checks of the
  Pallas kernel, the plain version and the per-token oracle, with every
  factor at most 1; and one TF32 product alone fails them. What the CPU
  cannot reproduce: the tensor cores' order of summation.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import peer_score as ref_ps
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.wkv_chunked import wkv_chunked as pallas_wkv
from repro_torch.kernels import ref
from repro_torch.kernels.peer_score import (FULL_M, MIN_SPLIT_P,
                                            gram_split_plan)
from repro_torch.kernels.wkv_chunked import wkv_chunked_plain

from test_torch_serve import WKV_CASES, _wkv_inputs

BLOCK_Q, BLOCK_KV = 128, 64   # the wgmma kernel's q block and kv tile
NEG = -1e30                   # the kernel's masked score (unscaled)
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
FTZ = 2.0 ** -126             # ex2.approx.ftz flushes results below this


def _tile_range(q0, *, sq_block, skv, causal, window, q_offset):
    """The kv tiles the kernel visits for the q block at q0: its band
    test solved for the first and last tile, written out from the
    kernel's t_begin / t_end."""
    row_lo = q0 + q_offset
    t_end = -(-skv // BLOCK_KV)
    if causal:
        t_end = min(t_end, (row_lo + sq_block - 1) // BLOCK_KV + 1)
    t_begin = max(0, (row_lo - window - (BLOCK_KV - 1)) // BLOCK_KV + 1) \
        if window else 0
    return range(t_begin, max(t_begin, t_end))


def _fma(a, b, c):
    """fmaf in f32: a·b is exact in f64, then one rounding there and one
    to f32."""
    return (a.double() * b.double() + c.double()).float()


def _ex2(x):
    """2^x in f32 with results below 2^-126 flushed to 0."""
    y = torch.exp2(x)
    return torch.where(y < FTZ, torch.zeros_like(y), y)


def wgmma_flash_emulation(q, k, v, *, causal, window, q_offset):
    """The wgmma kernel's arithmetic in PyTorch (f32 on the CPU), per q
    block of 128 rows and kv tile of 64 in its band, in order:
    s = q·kᵀ unscaled, masked to −1e30; m' = max(m, max(s)·scale);
    corr = 2^((m − m')·log2 e); p = 2^fma(s, scale·log2 e, −m'·log2 e),
    masked p 0; each row's sum l in four shares (the quad of lanes that
    holds the row: columns 8j + 2c, 8j + 2c + 1 in share c, pairs added
    first, then j in order), updated as fma(l, corr, sum); O = O·corr +
    hi·V + lo·V with hi = p rounded to q.dtype and lo = (p − hi) rounded;
    out = O · (1 / max((l₀ + l₁) + (l₂ + l₃), 1e-30)), rounded once."""
    dt = q.dtype
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    rep = h // kh
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    k2 = scale * LOG2E
    qf = q.float().reshape(b, sq, kh, rep, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]        # (B, K, 1, S, hd)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    out = torch.zeros_like(qf)
    for q0 in range(0, sq, BLOCK_Q):
        q1 = min(q0 + BLOCK_Q, sq)
        qb = qf[:, :, :, q0:q1]
        m = torch.full(qb.shape[:-1], NEG)
        l4 = torch.zeros(qb.shape[:-1] + (4,))
        acc = torch.zeros_like(qb)
        for t in _tile_range(q0, sq_block=BLOCK_Q, skv=skv, causal=causal,
                             window=window, q_offset=q_offset):
            c0, c1 = t * BLOCK_KV, min((t + 1) * BLOCK_KV, skv)
            s = qb @ kf[..., c0:c1, :].transpose(-1, -2)
            mask = ref.attention_mask(q1 - q0, c1 - c0, causal=causal,
                                      window=window,
                                      q_offset=q0 + q_offset - c0)
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1) * scale)
            corr = _ex2((m - m_new) * LOG2E)
            p = _ex2(_fma(s, k2, -(m_new * LOG2E)[..., None]))
            p = torch.where(mask, p, 0.0)
            # the row's lanes: p padded to 64 columns as (j, share c, pair)
            pairs = torch.nn.functional.pad(p, (0, BLOCK_KV - (c1 - c0)))
            pairs = pairs.unflatten(-1, (8, 4, 2))
            pairs = pairs[..., 0] + pairs[..., 1]
            part = pairs[..., 0, :]
            for j in range(1, 8):
                part = part + pairs[..., j, :]
            l4 = _fma(l4, corr[..., None], part)
            hi = p.to(dt).float()
            lo = (p - hi).to(dt).float()
            vt = vf[..., c0:c1, :]
            acc = acc * corr[..., None] + hi @ vt + lo @ vt
            m = m_new
        l = (l4[..., 0] + l4[..., 1]) + (l4[..., 2] + l4[..., 3])
        out[:, :, :, q0:q1] = acc * torch.reciprocal(
            l.clamp_min(1e-30))[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(dt)


# (B, Sq, Skv, H, K, hd, causal, window, q_offset)
FLASH_CASES = [
    (2, 200, 200, 12, 2, 128, True, 0, 0),     # qwen2's GQA (rep 6), ragged
    (1, 77, 130, 4, 4, 64, True, 16, 53),      # rep 1, window + q_offset
    (1, 50, 90, 6, 3, 64, False, 0, 0),        # rep 2, not causal
    (1, 33, 160, 6, 1, 128, True, 0, 127),     # a continuation chunk
    (1, 300, 300, 6, 1, 64, True, 100, 0),     # rep 6, window across tiles
    (1, 130, 257, 4, 2, 128, True, 60, 127),   # rep 2, all at once
    (1, 16, 16, 2, 2, 64, True, 4, -8),        # rows that see no key
]
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _flash_inputs(case):
    b, sq, skv, h, kh, hd = case[:6]
    rng = np.random.default_rng(sum(case))
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kh, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kh, hd)).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "b{}-q{}-kv{}-h{}-k{}-d{}-c{}-w{}-o{}"
                         .format(*(int(x) for x in c)))
def test_wgmma_flash_numerics_match_pallas(case, dtype):
    """The hi/lo P·V design within one ulp of the input type (plus 1e-5
    of the scale) of the Pallas kernel (interpret), the check the card
    holds the kernel to."""
    tdt, jdt = DTYPES[dtype]
    causal, window, q_offset = case[6:]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v = _flash_inputs(case)
    want = pallas_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                        interpret=True, **kw)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(tdt)
    got = wgmma_flash_emulation(*(torch.from_numpy(a).to(tdt)
                                  for a in (q, k, v)), **kw)
    assert got.dtype == tdt and got.shape == want.shape
    assert ref.within_ulps(got, want, n=1, rel_atol=1e-5)


def test_wgmma_flash_tile_range_matches_the_band_test():
    """The kernel's solved tile range equals the tiles that pass the
    Pallas band test, over offsets, windows and ragged lengths."""
    from repro_torch.kernels.flash_attention import in_band

    for skv in (1, 63, 64, 65, 300):
        for causal in (False, True):
            for window in (0, 1, 64, 100):
                for q_offset in (-200, -8, 0, 53, 127):
                    for q0 in (0, 128, 256):
                        row_lo = q0 + q_offset
                        want = [t for t in range(-(-skv // BLOCK_KV))
                                if in_band(row_lo, row_lo + BLOCK_Q - 1,
                                           t * BLOCK_KV,
                                           t * BLOCK_KV + BLOCK_KV - 1,
                                           skv=skv, causal=causal,
                                           window=window)]
                        got = list(_tile_range(
                            q0, sq_block=BLOCK_Q, skv=skv, causal=causal,
                            window=window, q_offset=q_offset))
                        assert got == want, (skv, causal, window, q_offset,
                                             q0)


# ---------------------------------------------------------------------------
# raw_gram split-K
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 15, 16, 17, 100, 333, 1023, 1024, 4096])
@pytest.mark.parametrize("p", [1, 63, 64, 65, 127, 128, 5130, 5131, 70001])
def test_gram_split_plan_covers_p_exactly(m, p):
    """Chunks [s·chunk, min((s+1)·chunk, P)) tile P with none empty; one
    split from M = 1024 on; at least MIN_SPLIT_P elements a chunk where P
    is split; the 16 tile only up to M = 16."""
    tile, splits, chunk = gram_split_plan(m, p)
    assert tile == (16 if m <= 16 else 64)
    assert splits >= 1 and chunk >= 1
    assert (splits - 1) * chunk < p <= splits * chunk
    bounds = [(s * chunk, min((s + 1) * chunk, p)) for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == p
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if m >= FULL_M:
        assert splits == 1
    if splits > 1:
        assert chunk >= MIN_SPLIT_P


def test_gram_split_plan_fills_the_card_at_the_round_shape():
    """M = 16, P = 5130 (the ResNet-18 header): one output tile, so P is
    split as far as MIN_SPLIT_P allows (~80 blocks); M = 100 has 4 tiles
    and ~2 × 132 / 4 splits."""
    assert gram_split_plan(16, 5130) == (16, 79, 65)
    tile, splits, _ = gram_split_plan(100, 5130)
    assert tile == 64 and splits * 4 <= 2 * 132 + 4 and splits > 1


@pytest.mark.parametrize("m", [1, 16, 17, 100])
@pytest.mark.parametrize("p", [1, 5130, 5131])
def test_split_gram_sum_matches_pallas(m, p):
    """Partial Grams over the plan's chunks, summed in ascending order (as
    the second kernel does), within 1e-5 of the largest entry of the
    Pallas raw_gram (interpret)."""
    x = np.random.default_rng(m * 7 + p).normal(size=(m, p)).astype(
        np.float32)
    want = np.asarray(ref_ps.raw_gram(jnp.asarray(x), interpret=True))
    _, splits, chunk = gram_split_plan(m, p)
    xt = torch.from_numpy(x)
    got = None
    for s in range(splits):
        part = xt[:, s * chunk:(s + 1) * chunk]
        part = part @ part.T
        got = part if got is None else got + part
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max())


# ---------------------------------------------------------------------------
# wkv_chunked: two passes, sub-chunk factored form, 3xTF32
# ---------------------------------------------------------------------------

CHUNK, SUB = 64, 16   # the kernels' chunk and sub-chunk of tokens


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, on the f32 bits: what cvt.rna.tf32.f32 leaves (the f32 layout
    with the low 13 bits 0)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b, lo=True):
    """a @ b as the kernels' mma.sync products: each f32 operand split into
    hi = tf32(x) and lo = tf32(x − hi), and lo·hi + hi·lo + hi·hi summed in
    f32 (without `lo`, hi·hi alone: one TF32 product)."""
    ah, bh = _tf32(a), _tf32(b)
    if not lo:
        return ah @ bh
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _in_order(factors, one):
    """((1·f₀)·f₁)·… : a product taken in the kernels' order."""
    out = one
    for f in factors:
        out = out * f
    return out


def _sub_products(w):
    """Per sub-chunk of 16 tokens of w (…, 64, hd): the exclusive prefix
    products lx_t = Π_{start ≤ q < t} w_q and suffix products
    rx_s = Π_{s < q ≤ end} w_q, each taken from the sub-chunk's edge
    inwards, and the totals T (…, 4, hd)."""
    ws = w.unflatten(-2, (CHUNK // SUB, SUB))
    one = torch.ones_like(ws[..., 0, :])
    lx, rx = [one], [one]
    for q in range(SUB - 1):
        lx.append(lx[-1] * ws[..., q, :])
        rx.append(rx[-1] * ws[..., SUB - 1 - q, :])
    total = lx[-1] * ws[..., SUB - 1, :]
    return (torch.stack(lx, -2).flatten(-3, -2),
            torch.stack(rx[::-1], -2).flatten(-3, -2), total)


def wkv_two_pass_emulation(r, k, v, w, u, state=None, *, lo=True):
    """The two CUDA kernels of csrc/wkv_chunked.cu in PyTorch (f32, CPU),
    step for step. Chunks of 64 tokens (a tail acts as w = 1, r = k = v =
    0), sub-chunks of 16. Every decay factor is a product of w taken in
    the kernels' order (`_sub_products`, `_in_order`), never an exp of a
    difference of log-w prefix sums: e^{cum_prev_t − cum_s} is
    Π_{s<q<t} w_q.
    State pass: per chunk, S_c (the state entering it) is kept, then
    S ← D·S + (k ⊙ rx ⊙ T_{b+1}⋯T₃)ᵀ·v, D = T₀T₁T₂T₃ (s in sub-chunk b).
    Output pass, per chunk: o = (r ⊙ lx ⊙ T₀⋯T_{a−1})·S_c + A·v, where
    A's off-diagonal sub-blocks (a > b) are the factored product
    (r_a ⊙ lx)·(k_b ⊙ rx ⊙ T_{b+1}⋯T_{a−1})ᵀ, its diagonal sub-blocks
    Σ_i (r_t k_s)·P_{ts} with P_{ts} = Π_{s<q<t} w_q built downwards from
    s = t − 1 (the decay inside the sum), and the bonus Σ_i (r_t k_t) u
    at s = t. Every product of matrices is `_mm3`. → (out in r.dtype,
    final state, every decay factor formed, by name)."""
    b, s, h, hd = r.shape
    nc = -(-s // CHUNK)
    ps = nc * CHUNK - s
    n_sub = CHUNK // SUB

    def chunks(a, fill):
        a = torch.nn.functional.pad(a.float(), (0, 0, 0, 0, 0, ps),
                                    value=fill)
        return a.reshape(b, nc, CHUNK, h, hd).permute(0, 3, 1, 2, 4)

    rc, kc, vc, wc = (chunks(a, f) for a, f in ((r, 0.0), (k, 0.0),
                                               (v, 0.0), (w, 1.0)))
    lx, rx, tot = _sub_products(wc)
    one = torch.ones_like(tot[..., 0, :])
    before = [_in_order([tot[..., m, :] for m in range(a)], one)
              for a in range(n_sub + 1)]          # T₀⋯T_{a−1}
    after = [_in_order([tot[..., m, :] for m in range(bb + 1, n_sub)], one)
             for bb in range(n_sub)]              # T_{b+1}⋯T₃
    sub = lambda x, a: x[..., SUB * a:SUB * (a + 1), :]  # noqa: E731

    st = torch.zeros((b, h, hd, hd)) if state is None else state.float()
    s_in = []
    k_dec = torch.cat([sub(kc * rx, bb) * after[bb][..., None, :]
                       for bb in range(n_sub)], -2)
    for c in range(nc):
        s_in.append(st)
        st = before[n_sub][:, :, c, :, None] * st + _mm3(
            k_dec[:, :, c].transpose(-1, -2), vc[:, :, c], lo)

    r_t = rc * lx
    r_cross = torch.cat([sub(r_t, a) * before[a][..., None, :]
                         for a in range(n_sub)], -2)
    o = _mm3(r_cross, torch.stack(s_in, 2), lo)
    a_mat = torch.zeros(rc.shape[:-1] + (CHUNK,))
    for a in range(n_sub):
        for bb in range(a):
            mid = _in_order([tot[..., m, :] for m in range(bb + 1, a)], one)
            k_mid = sub(kc * rx, bb) * mid[..., None, :]
            a_mat[..., SUB * a:SUB * (a + 1), SUB * bb:SUB * (bb + 1)] = \
                _mm3(sub(r_t, a), k_mid.transpose(-1, -2), lo)
    p_diag = []
    for a in range(n_sub):
        rr, kk, ww = sub(rc, a), sub(kc, a), sub(wc, a)
        blk = torch.zeros(rr.shape[:-1] + (SUB,))
        for t in range(SUB):
            p = torch.ones_like(rr[..., 0, :])
            for s_ in range(t - 1, -1, -1):
                p_diag.append(p)
                blk[..., t, s_] = ((rr[..., t, :] * kk[..., s_, :])
                                   * p).sum(-1)
                p = p * ww[..., s_, :]
            blk[..., t, t] = ((rr[..., t, :] * kk[..., t, :])
                              * u.float()[None, :, None, :]).sum(-1)
        a_mat[..., SUB * a:SUB * (a + 1), SUB * a:SUB * (a + 1)] = blk
    o = o + _mm3(a_mat, vc, lo)
    factors = dict(lx=lx, rx=rx, totals=tot, decay=before[n_sub],
                   diag=torch.stack(p_diag),
                   **{f"before{a}": before[a] for a in range(n_sub)},
                   **{f"after{bb}": after[bb] for bb in range(n_sub)})
    out = o.permute(0, 2, 3, 1, 4).reshape(b, nc * CHUNK, h, hd)[:, :s]
    return out.to(r.dtype), st, factors


# (B, S, H, dtype of r/k/v, initial state, highest log-log decay, decays):
# decays "zero" sets w = 0 in a quarter of the channels (the 1e-38 clamp
# takes them), "one" sets w = 1 everywhere, "draw" keeps the draw
# w = exp(−exp(U[−6, hi])); hi = 4.5 reaches w = e^{−90}
WKV_EDGE_CASES = [
    (1, 150, 2, "float32", True, 1.0, "zero"),
    (1, 100, 2, "float32", True, 1.0, "one"),
    (2, 130, 2, "float32", True, 4.5, "draw"),
]
# the serving cases, an f16 one (ragged, with state) and the edge cases
WKV_ALL_CASES = [c + ("draw",) for c in WKV_CASES] + \
    [(1, 150, 2, "float16", True, 1.0, "draw")] + WKV_EDGE_CASES


def _wkv_case(case):
    b, s, h, dtype, state, hi, decays = case
    r, k, v, w, u, s0 = _wkv_inputs(b, s, h, state, hi, seed=s + h)
    if decays == "zero":
        w[..., ::4] = 0.0
    elif decays == "one":
        w[...] = 1.0
    return (r, k, v, w, u, s0), dtype


def _wkv_checks(got, got_s, want, want_s, dtype):
    """The checks the card holds the kernel to, on the CPU's scale: bf16
    and f16 within one ulp, f32 within 1e-5 of max(1, max|out|), state
    within 1e-5 of max(1, max|S|). → the names of the checks that
    failed."""
    bad = []
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype != "float32":
        tdt = getattr(torch, dtype)
        if not ref.within_ulps(torch.from_numpy(got).to(tdt),
                               torch.from_numpy(want).to(tdt)):
            bad.append("out")
    elif np.abs(got - want).max() > 1e-5 * max(1.0, np.abs(want).max()):
        bad.append("out")
    want_s = np.asarray(want_s, np.float32)
    if np.abs(got_s.numpy() - want_s).max() > \
            1e-5 * max(1.0, np.abs(want_s).max()):
        bad.append("state")
    return bad


def _wkv_wants(arrays, dtype, decays):
    """The references on the same inputs, [(out, state)] as numpy f32: the
    reference's per-token oracle `wkv_ref`, and for the drawn decays up
    to hi = 1 and for w = 1 also the Pallas kernel (interpret) and
    `wkv_chunked_plain`. Beyond those the two chunked forms are no
    reference at these tolerances: both take e^{cum_prev − cum} of log-w
    prefix sums, whose rounding is ~ε·|cum| (|cum| up to 64·87.5 at
    w = 0), which puts the plain version further from the oracle than
    these tolerances (chip_smoke.py prints that distance on the card);
    and XLA on the CPU flushes the 1e-38 clamp (a subnormal) to 0, so the
    Pallas kernel returns NaN for w below 1.2e-38."""
    r, k, v, w, u, s0 = arrays
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jr, jk, jv = (jnp.asarray(a, jdt) for a in (r, k, v))
    js0 = None if s0 is None else jnp.asarray(s0)
    wants = [jref.wkv_ref(jr, jk, jv, jnp.asarray(w), jnp.asarray(u), js0)]
    if decays == "one" or (decays == "draw" and
                           float(w.min()) >= np.finfo(np.float32).tiny):
        wants.append(pallas_wkv(jr, jk, jv, jnp.asarray(w), jnp.asarray(u),
                                js0, interpret=True))
        wants.append(wkv_chunked_plain(
            *(torch.from_numpy(a).to(tdt) for a in (r, k, v)),
            torch.from_numpy(w), torch.from_numpy(u),
            None if s0 is None else torch.from_numpy(s0)))
    return [(np.asarray(o.float() if isinstance(o, torch.Tensor)
                        else o.astype(jnp.float32), np.float32),
             np.asarray(st, np.float32)) for o, st in wants]


def _wkv_emulate(arrays, dtype, lo=True):
    r, k, v, w, u, s0 = arrays
    tdt = getattr(torch, dtype)
    return wkv_two_pass_emulation(
        *(torch.from_numpy(a).to(tdt) for a in (r, k, v)),
        torch.from_numpy(w), torch.from_numpy(u),
        None if s0 is None else torch.from_numpy(s0), lo=lo)


@pytest.mark.parametrize("case", WKV_ALL_CASES,
                         ids=lambda c: "b{}-s{}-h{}-{}-state{}-hi{}-{}"
                         .format(*c))
def test_wkv_two_pass_numerics_match_pallas_and_plain(case):
    """The two-pass, sub-chunk factored, 3xTF32 design within the card's
    checks of the Pallas kernel (interpret) and of the plain version, and
    every exp factor it forms finite and at most 1: no factor can
    overflow, whatever the decay."""
    arrays, dtype = _wkv_case(case)
    got, got_s, factors = _wkv_emulate(arrays, dtype)
    assert got.dtype == getattr(torch, dtype)
    for name, f in factors.items():
        assert bool(torch.isfinite(f).all()), name
        assert float(f.max()) <= 1.0, name
    wants = _wkv_wants(arrays, dtype, case[-1])
    assert len(wants) == (1 if case[-1] == "zero" or case[5] > 1 else 3)
    for want, want_s in wants:
        assert _wkv_checks(got, got_s, want, want_s, dtype) == []


def test_wkv_two_pass_needs_the_lo_terms():
    """One TF32 product (hi·hi alone) fails a check that 3xTF32 passes:
    the split is what holds the kernel to the reference."""
    failed = []
    for case in WKV_ALL_CASES:
        arrays, dtype = _wkv_case(case)
        got, got_s, _ = _wkv_emulate(arrays, dtype, lo=False)
        want, want_s = _wkv_wants(arrays, dtype, case[-1])[0]
        failed += _wkv_checks(got, got_s, want, want_s, dtype)
    assert failed, "one TF32 product passed every check"
