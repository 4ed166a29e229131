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

from repro.kernels import mask_evolve as ref_me
from repro.kernels import peer_score as ref_ps
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.wkv_chunked import wkv_chunked as pallas_wkv
from repro_torch.kernels import mask_evolve, ref, select_score
from repro_torch.kernels.peer_score import (FULL_M, MIN_SPLIT_P,
                                            gram_split_plan)
from repro_torch.kernels.wkv_chunked import wkv_chunked_plain

from test_torch_kernels import _assert_same_zeros_up_to_sign
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


# ---------------------------------------------------------------------------
# mask_evolve: radix select, one call over a list of leaves
# ---------------------------------------------------------------------------

def radix_select_emulation(x, kth):
    """The kernel's threshold, pass for pass: 8-bit digits of |x|'s
    float32 bits from the top (bits 30..24, 23..16, 15..8, 7..0; a
    bfloat16 leaf stops after two), each pass a histogram of the digit
    over the elements whose higher digits equal the prefix, then the first
    digit at which the running count reaches the target left; the
    elements below it leave the target. The result clamped to 0x7F800001,
    where the bisection ends when the kth-smallest |x| is a NaN.
    → (threshold bits as an int, passes taken)."""
    bits = x.float().abs().reshape(-1).view(torch.int32).long()
    passes = mask_evolve.PASSES[x.dtype]
    prefix, target = 0, kth + 1
    for pas, shift in enumerate(mask_evolve.DIGIT_SHIFTS[:passes]):
        high = 31 if pas == 0 else shift + 8
        same = (bits >> high) == (prefix >> high)
        hist = torch.bincount((bits[same] >> shift) & 0xFF, minlength=256)
        upto = torch.cumsum(hist, 0)
        digit = int(torch.nonzero(upto >= target)[0])
        target -= int(upto[digit] - hist[digit])
        prefix |= digit << shift
    return min(prefix, mask_evolve.NAN_END_BITS), passes


def _radix_input(kind, dtype, seed):
    """Magnitudes that stress the select: normal draws; heavy ties; ±0
    beside small values; subnormals; +inf; a NaN at the kth position."""
    rng = np.random.default_rng(seed)
    n = 3001
    if kind == "ties":
        x = rng.integers(-3, 4, size=n).astype(np.float32) * 0.5
    elif kind == "zeros":
        x = rng.normal(size=n).astype(np.float32)
        x[: n // 2] = 0.0
        x[: n // 4] = -0.0
    elif kind == "subnormal":
        tiny = np.finfo(np.float32).tiny
        x = (rng.integers(1, 60, size=n) * tiny / 64).astype(np.float32)
        x *= rng.choice([-1, 1], size=n).astype(np.float32)
        x[::7] = rng.normal(size=x[::7].shape)
    elif kind == "inf":
        x = rng.normal(size=n).astype(np.float32)
        x[::5] = np.inf
        x[1::9] = -np.inf
    else:
        x = rng.normal(size=n).astype(np.float32)
    t = torch.from_numpy(x).to(dtype)
    if kind == "nan":
        t[n // 2:] = torch.nan       # the upper half, kth = n/2 among it
    return t


RADIX_KINDS = ["normal", "ties", "zeros", "subnormal", "inf", "nan"]


@pytest.mark.parametrize("kind", RADIX_KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("keep_kind", ["one", "half", "all"])
def test_radix_select_matches_bisection_and_reference(kind, dtype,
                                                      keep_kind):
    """Bitwise: the radix select's threshold against the plain version's
    bisection and the reference's (`magnitude_threshold`); the Pallas
    kernel (interpret) then gives the mask this threshold gives and the
    output up to the sign of dropped zeros (and of dropped NaNs, which
    its select makes 0), except where the threshold is subnormal: XLA on
    the CPU flushes it and |x| to 0 before comparing. A NaN at the kth position
    gives 0x7F800001, where the bisection ends then (a NaN threshold:
    only the regrowth is kept); bfloat16 takes two passes."""
    x = _radix_input(kind, dtype, seed=RADIX_KINDS.index(kind))
    n = x.numel()
    keep = {"one": 1, "half": n // 2, "all": n}[keep_kind]
    got, passes = radix_select_emulation(x, n - keep)
    assert passes == (2 if dtype == torch.bfloat16 else 4)
    want = mask_evolve.magnitude_threshold_plain(x, n - keep)
    assert got == int(want.view(torch.int32))
    jx = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    flat = jnp.abs(jx.astype(jnp.float32)).ravel()
    ref_thr = np.asarray(ref_me.magnitude_threshold(flat, n - keep))
    assert got == int(ref_thr.view(np.int32))
    if kind == "nan" and keep_kind != "all":
        assert got == mask_evolve.NAN_END_BITS
    grow = torch.from_numpy(np.random.default_rng(n).uniform(size=n) > 0.98)
    out, mask, thr = mask_evolve.mask_evolve_plain(x, grow, keep=keep)
    if 0 < float(thr) < np.finfo(np.float32).tiny:
        return   # XLA on the CPU flushes a subnormal |x| and threshold to 0
    kern_out, kern_mask = ref_me.mask_evolve(jx, jnp.asarray(grow.numpy()),
                                             keep=keep, interpret=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(kern_mask))
    # XLA turns the Pallas kernel's x·mask into a select: a dropped NaN
    # becomes 0 there, NaN in the product
    real = ~torch.isnan(x)
    _assert_same_zeros_up_to_sign(out[real], np.asarray(kern_out)[real.numpy()])


def _find_leaf(begins, block):
    """The kernel's search: the last row whose first block is ≤ block."""
    lo, hi = 0, len(begins) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if begins[mid] <= block:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _chunk_cover(n, nb, vec):
    """How often the kernel's loops touch each element of an n-element
    leaf with nb blocks: block j's threads take 16-byte vectors of `vec`
    elements j·T + t, then + nb·T, …; then the elements past the last
    whole vector the same way (vec = 1: the scalar loop alone)."""
    t = mask_evolve.THREADS
    cover = np.zeros(n, np.uint8)
    nv = n // vec if vec > 1 else 0
    for j in range(nb):
        for u in range(j * t, nv, nb * t):
            cover[u * vec:min(u + t, nv) * vec] += 1
        for i in range(nv * vec + j * t, n, nb * t):
            cover[i:min(i + t, n)] += 1
    return cover


def test_leaf_table_covers_every_element_once():
    """Leaves of 1, 10, 2,359,296×16 and 700,001 elements, bfloat16 and
    float32 mixed: every block of the grid finds one leaf, each leaf's
    blocks are 0..nb−1, float32 leaves come first and own exactly the
    first grid_deep blocks, and the vector and scalar loops touch every
    element exactly once, with 16-byte vectors and without."""
    sizes = [1, 10, 2_359_296 * 16, 700_001, 10, 700_001]
    dtypes = [torch.bfloat16, torch.float32, torch.bfloat16, torch.bfloat16,
              torch.bfloat16, torch.float32]
    order, begins, grid, grid_deep = mask_evolve.leaf_plan(sizes, dtypes)
    assert sorted(order) == list(range(len(sizes)))
    deep = [mask_evolve.PASSES[dtypes[i]] == 4 for i in order]
    assert deep == sorted(deep, reverse=True)
    assert grid_deep == (begins[sum(deep)] if sum(deep) < len(order)
                         else grid)
    blocks = [mask_evolve.leaf_blocks(sizes[i]) for i in order]
    assert begins == list(np.cumsum([0] + blocks[:-1]))
    assert grid == sum(blocks)
    seen = [[] for _ in order]
    for b in range(grid):
        row = _find_leaf(begins, b)
        seen[row].append(b - begins[row])
    assert seen == [list(range(nb)) for nb in blocks]
    assert max(blocks) == mask_evolve.MAX_LEAF_BLOCKS
    for row, i in enumerate(order):
        vec = 8 if dtypes[i] == torch.bfloat16 else 4
        for v in (vec, 1):
            cover = _chunk_cover(sizes[i], blocks[row], v)
            assert cover.min() == 1 and cover.max() == 1, (sizes[i], v)


# ---------------------------------------------------------------------------
# select_topk: column and P splits, an ordered top-k merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 15, 16, 17, 100, 132, 700, 1023, 1024,
                               2100, 4096])
@pytest.mark.parametrize("p", [1, 63, 65, 257, 5130, 5131, 70001])
def test_select_plan_covers_columns_and_p_exactly(m, p):
    """Column splits [c·per, min((c+1)·per, tiles)) tile the ceil(M/128)
    column tiles, P chunks [s·chunk, min((s+1)·chunk, P)) tile P, none
    empty; vec (4, 2 or 1) divides P and the chunk; P is split only while
    the (row, column) tiles stay at most half the target, at least
    MIN_SPLIT_P a chunk; at most one wave of TARGET_BLOCKS blocks where
    the row tiles allow it."""
    vec, splits, per, p_splits, chunk = select_score.select_plan(m, p)
    tiles = math.ceil(m / select_score.TILE_N)
    row_tiles = math.ceil(m / select_score.TILE_M)
    assert (splits - 1) * per < tiles <= splits * per
    assert (p_splits - 1) * chunk < p <= p_splits * chunk
    assert vec in (1, 2, 4) and p % vec == 0 and chunk % vec == 0
    assert vec == 4 or p % (2 * vec)
    if p_splits > 1:
        assert 2 * row_tiles * tiles <= select_score.TARGET_BLOCKS
        assert chunk >= MIN_SPLIT_P - vec
        assert row_tiles * tiles * p_splits <= select_score.TARGET_BLOCKS
    assert row_tiles * splits <= select_score.TARGET_BLOCKS or splits == 1


def test_select_plan_at_the_round_and_population_shapes():
    """M = 16: one tile, so P is cut into ~80 chunks; M = 1024: one column
    tile a split and two P chunks; M = 4096: 4 splits of 8 column tiles
    (128 blocks, one wave), all of P in each block."""
    assert select_score.select_plan(16, 5130) == (2, 1, 1, 78, 66)
    assert select_score.select_plan(1024, 5130) == (2, 8, 1, 2, 2566)
    assert select_score.select_plan(4096, 5130) == (2, 4, 8, 1, 5130)


def _fold(carry_v, carry_i, v, c):
    """The kernel's insertion, for every row at once: v enters if it beats
    the k-th strictly, behind every entry ≥ v (ties keep the earlier)."""
    k = carry_v.shape[1]
    pos = (carry_v >= v[:, None]).sum(1, keepdim=True)
    j = torch.arange(k)[None, :]
    prev_v = torch.cat([carry_v[:, :1], carry_v[:, :-1]], 1)
    prev_i = torch.cat([carry_i[:, :1], carry_i[:, :-1]], 1)
    new_v = torch.where(j < pos, carry_v,
                        torch.where(j == pos, v[:, None], prev_v))
    new_i = torch.where(j < pos, carry_i,
                        torch.where(j == pos, c[:, None], prev_i))
    return new_v, new_i


def split_topk_emulation(scores, k, *, splits, per, tile):
    """Top-k of dense (M, M) scores as the kernel forms it: split c folds
    its column tiles [c·per, (c+1)·per) of `tile` columns in ascending
    column order into a carry of k (−inf, 0) entries; then the splits'
    carries are folded in ascending split order, each list in its own
    (descending) order. → (values, int32 indices)."""
    m = scores.shape[0]
    carries = []
    for c in range(splits):
        cv = torch.full((m, k), -torch.inf)
        ci = torch.zeros((m, k), dtype=torch.int64)
        for col in range(c * per * tile, min((c + 1) * per * tile, m)):
            cv, ci = _fold(cv, ci, scores[:, col],
                           torch.full((m,), col, dtype=torch.int64))
        carries.append((cv, ci))
    mv, mi = carries[0]
    for cv, ci in carries[1:]:
        for j in range(k):
            mv, mi = _fold(mv, mi, cv[:, j], ci[:, j])
    return mv, mi.to(torch.int32)


def _tie_inputs(m, p, kind, seed):
    """Tie-heavy select inputs: `columns` — the rows of x take a few
    values, so whole columns of cos are equal; `all` — every row of x
    equal, s_l one value and never selected, so every off-diagonal score
    is equal; `draw` — normal draws."""
    rng = np.random.default_rng(seed)
    x, last, s_l, t, cost, mask = _select_inputs(m, p, rng)
    if kind == "columns":
        x = x[rng.integers(0, min(3, m), size=m)]
        s_l = np.repeat(s_l[:, :1], m, axis=1)
        last[...] = -1
    elif kind == "all":
        x = np.repeat(x[:1], m, axis=0)
        s_l[...] = 1.5
        last[...] = -1
    return x, last, s_l, t, cost, mask


def _select_inputs(m, p, rng):
    x = rng.normal(size=(m, p)).astype(np.float32)
    last = rng.integers(-1, 3, size=(m, m)).astype(np.int32)
    s_l = rng.uniform(0.0, 3.0, size=(m, m)).astype(np.float32)
    return x, last, s_l, 3, np.float32(1.0), None


SPLIT_CASES = [(1, 1), (2, 1), (16, 4), (16, 15), (17, 16), (17, 10),
               (1024, 10), (1024, 32)]


@pytest.mark.parametrize("m,k", SPLIT_CASES)
@pytest.mark.parametrize("kind", ["columns", "all", "draw"])
def test_split_topk_merge_reproduces_stable_topk(m, k, kind):
    """The fold of each split's column tiles and the ordered merge of the
    splits give `select_topk_ref`'s values and indices exactly, ties to the
    lowest column: with the kernel's plan (128-column tiles) and with a
    narrow one (4-column tiles, 2 a split) that puts tied columns in
    different splits at every M."""
    args = _tie_inputs(m, 33, kind, seed=m + k)
    targs = [torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
             else a for a in args]
    targs[4] = float(targs[4])
    want_v, want_i, _ = ref.select_topk_ref(*targs, k=k, alpha=1.0, lam=0.5)
    scores, _ = ref.select_score_ref(*targs, alpha=1.0, lam=0.5)
    _, splits, per, _, _ = select_score.select_plan(m, 33)
    narrow = math.ceil(math.ceil(m / 4) / 2)
    for plan in ((splits, per, select_score.TILE_N), (narrow, 2, 4)):
        v, i = split_topk_emulation(scores, k, splits=plan[0], per=plan[1],
                                    tile=plan[2])
        assert torch.equal(i, want_i), plan
        assert torch.equal(v, want_v), plan
    if kind == "all" and m > 2:
        assert (want_i[:, 0] == (torch.arange(m) == 0).int()).all()


@pytest.mark.parametrize("kind", ["columns", "draw"])
def test_split_topk_merge_matches_pallas(kind):
    """At M = 37, P = 130, k = 10, in 4-column tiles 2 to a split (5
    splits): the emulated merge of the port's dense scores gives the
    Pallas select_topk's (interpret) indices exactly and its values within
    rtol 1e-5 (the two Grams sum P products in other orders)."""
    from repro.kernels import select_score as ref_ss

    m, k = 37, 10
    x, last, s_l, t, cost, mask = _tie_inputs(m, 130, kind, seed=5)
    rv, ri, _ = ref_ss.select_topk(jnp.asarray(x), jnp.asarray(last),
                                   jnp.asarray(s_l), jnp.int32(t),
                                   jnp.asarray(cost), None, k=k, alpha=1.0,
                                   lam=0.5, interpret=True)
    scores, _ = ref.select_score_ref(torch.from_numpy(x),
                                     torch.from_numpy(last),
                                     torch.from_numpy(s_l), t, float(cost),
                                     alpha=1.0, lam=0.5)
    v, i = split_topk_emulation(scores, k, splits=5, per=2, tile=4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5)


@pytest.mark.parametrize("m", [2, 16, 17, 132])
def test_p_split_route_matches_reference_and_pallas(m):
    """The P-split route's arithmetic at P = 5130: partial Grams over the
    plan's P chunks, summed in ascending order, then the cosine and Eq. 9,
    within 1e-5 of the reference's dense scores (`select_score_ref`); its
    top-k through the split merge gives the Pallas select_topk's
    (interpret) indices exactly and values within rtol 1e-5."""
    from repro.kernels import select_score as ref_ss

    k = min(10, m - 1)
    rng = np.random.default_rng(m)
    x, last, s_l, t, cost, _ = _select_inputs(m, 5130, rng)
    _, splits, per, p_splits, chunk = select_score.select_plan(m, 5130)
    assert p_splits > 1
    xt = torch.from_numpy(x)
    gram = None
    for s in range(p_splits):
        part = xt[:, s * chunk:(s + 1) * chunk]
        gram = part @ part.T if gram is None else gram + part @ part.T
    inv = ref.inverse_norms(xt)
    cos = (gram * inv[:, None] * inv[None, :]).clamp(-1.0, 1.0)
    sp = ref.recency(torch.from_numpy(last), t, 0.5)
    got = sp * (1.0 * torch.from_numpy(s_l) - cos + float(cost))
    got.fill_diagonal_(ref.NEG)
    jargs = (jnp.asarray(x), jnp.asarray(last), jnp.asarray(s_l),
             jnp.int32(t), jnp.asarray(cost))
    want, _ = jref.select_score_ref(*jargs, alpha=1.0, lam=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    rv, ri, _ = ref_ss.select_topk(*jargs, None, k=k, alpha=1.0, lam=0.5,
                                   interpret=True)
    v, i = split_topk_emulation(got, k, splits=splits, per=per,
                                tile=select_score.TILE_N)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5)
