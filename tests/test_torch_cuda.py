"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: they skip where torch.cuda.is_available() is false (the
kernels have no CPU mode). This file imports no jax, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import ops

ALPHA, LAM = 1.0, 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False); the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(m, p, seed, dev, *, matrix_cost, cand):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, p), generator=g, device=dev)
    last = torch.randint(-1, 3, (m, m), generator=g, device=dev,
                         dtype=torch.int32)
    s_l = torch.rand((m, m), generator=g, device=dev) * 3.0
    cost = (torch.rand((m, m), generator=g, device=dev) + 0.5
            if matrix_cost else 1.0)
    mask = (torch.rand((m, m), generator=g, device=dev) < 0.7) if cand \
        else None
    return x, last, s_l, 3, cost, mask


@pytest.mark.cuda
@pytest.mark.parametrize("m,p", [(16, 5130), (37, 130), (300, 700)])
def test_raw_gram_kernel_matches_plain(cuda, m, p):
    """Error ≤ 1e-4 × the largest entry: fp32 FFMA sums of P products in
    another order than the matmul."""
    x = torch.randn(m, p, device=cuda)
    got = ops.raw_gram(x)
    want = ops.raw_gram(x, impl="plain")
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,p", [(16, 5130), (17, 5131), (100, 5130),
                                 (1024, 700)])
def test_raw_gram_kernel_is_bitwise_repeatable(cuda, m, p):
    """Split-K without float atomics: two launches agree bitwise, with
    several splits (M < 1024) and with one (M = 1024)."""
    from repro_torch.kernels.peer_score import gram_split_plan

    assert (gram_split_plan(m, p)[1] == 1) == (m >= 1024)
    x = torch.randn(m, p, device=cuda)
    a, b = ops.raw_gram(x), ops.raw_gram(x)
    assert ops.KERNELS["raw_gram"].last_plan == gram_split_plan(m, p)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(5, 4), (16, 4), (37, 10), (700, 10),
                                 (2100, 32)])
@pytest.mark.parametrize("matrix_cost,cand", [(False, False), (True, True)])
def test_select_topk_kernel_matches_plain(cuda, m, k, matrix_cost, cand):
    """Indices exact; values rtol 1e-4, row stats rtol 1e-4 + atol 1e-6·M
    (sums of M cosines). The scores are uniform draws of s_l over [0, 3),
    so ties closer than the kernels' rounding are rare at these sizes."""
    args = _case(m, 257, m, cuda, matrix_cost=matrix_cost, cand=cand)
    v, i, s = ops.select_topk(*args, k=k, alpha=ALPHA, lam=LAM)
    pv, pi, ps = ops.select_topk(*args, k=k, alpha=ALPHA, lam=LAM,
                                 impl="plain")
    assert torch.equal(i, pi)
    torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s, ps, rtol=1e-4, atol=1e-6 * m)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 17, 132, 1024, 4096])
@pytest.mark.parametrize("k", [10, 32])
def test_select_topk_kernel_matches_plain_where_the_plan_changes(cuda, m,
                                                                 k):
    """At M where select_plan changes (P splits at 16, 17, 132 and 1024;
    column splits from 132; all of P a block at 4096), P = 5130, k capped
    at M − 1: indices
    exact but for swaps of scores within 1e-5 relative of each other (the
    two Grams round differently), at most one in 2,000; values rtol 1e-4,
    row stats rtol 1e-4 + atol 1e-6·M; a second call bitwise equal."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.select_score import select_plan

    k = min(k, m - 1)
    args = _case(m, 5130, m + k, cuda, matrix_cost=m % 2 == 0,
                 cand=m == 132)
    v, i, s = ops.select_topk(*args, k=k, alpha=ALPHA, lam=LAM)
    assert ops.KERNELS["select_topk"].last_plan == select_plan(m, 5130)
    v2, i2, s2 = ops.select_topk(*args, k=k, alpha=ALPHA, lam=LAM)
    pv, pi, ps = ops.select_topk(*args, k=k, alpha=ALPHA, lam=LAM,
                                 impl="plain")
    bad = i != pi
    if bad.any():
        dense, _ = ref.select_score_ref(*args, alpha=ALPHA, lam=LAM)
        rows, slots = bad.nonzero(as_tuple=True)
        got_s = dense[rows, i[rows, slots].long()]
        want_s = dense[rows, pi[rows, slots].long()]
        assert bool(((got_s - want_s).abs() <= 1e-5 * want_s.abs()).all())
        assert int(bad.sum()) * 2000 <= i.numel()
    torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s, ps, rtol=1e-4, atol=1e-6 * m)
    assert torch.equal(i, i2) and torch.equal(v.view(torch.int32),
                                              v2.view(torch.int32))
    assert torch.equal(s.view(torch.int32), s2.view(torch.int32))


@pytest.mark.cuda
def test_select_topk_kernel_ties_go_to_lowest_column(cuda):
    """Exactly tied scores: the lowest columns win, as in lax.top_k."""
    m, k = 70, 5
    x = torch.arange(1, 7, dtype=torch.float32, device=cuda).repeat(m, 1)
    last = torch.full((m, m), -1, dtype=torch.int32, device=cuda)
    s_l = torch.ones((m, m), device=cuda)
    _, i, _ = ops.select_topk(x, last, s_l, 2, 0.5, k=k, alpha=ALPHA,
                              lam=LAM)
    want = torch.tensor([[j for j in range(m) if j != r][:k]
                         for r in range(m)], dtype=torch.int32)
    assert torch.equal(i.cpu(), want)


@pytest.mark.cuda
def test_kernels_count_launches_and_refuse_bad_input(cuda):
    ops.reset_launch_counts()
    x = torch.randn(8, 33, device=cuda)
    ops.raw_gram(x)
    last = torch.full((8, 8), -1, dtype=torch.int32, device=cuda)
    s_l = torch.rand(8, 8, device=cuda)
    ops.select_topk(x, last, s_l, 0, 1.0, k=3, alpha=ALPHA, lam=LAM)
    assert ops.launch_counts() == {"flash_attention": 0, "gossip_mix": 0,
                                   "mask_evolve": 0, "raw_gram": 1,
                                   "select_topk": 1, "wkv_chunked": 0}
    from repro_torch.kernels.select_score import select_topk_cuda

    with pytest.raises(ValueError):
        select_topk_cuda(x, last.float(), s_l, 0, 1.0, k=3, alpha=ALPHA,
                         lam=LAM)
    with pytest.raises(ValueError):
        ops.select_topk(torch.randn(40, 3, device=cuda),
                        torch.full((40, 40), -1, dtype=torch.int32,
                                   device=cuda),
                        torch.rand(40, 40, device=cuda), 0, 1.0, k=33,
                        alpha=ALPHA, lam=LAM)


def _gossip_case(m, f, k, seed, dev, *, directed=True):
    """A plan-shaped instance: random k-peer selection (symmetrized when
    undirected), some inactive rows, row-stochastic weights with self,
    packed lists."""
    from repro_torch.core.aggregation import selection_to_weights
    from repro_torch.fl.engine import gossip_edges
    from repro_torch.kernels.gossip_mix import (gossip_degree_bound,
                                                weights_to_neighbors)

    g = torch.Generator(device=dev).manual_seed(seed)
    mask = gossip_edges(torch.rand((m, m), generator=g, device=dev), k,
                        directed=directed)
    mask &= (torch.rand((m,), generator=g, device=dev) < 0.7)[:, None]
    w = selection_to_weights(mask, include_self=True)
    idx, wl = weights_to_neighbors(w, gossip_degree_bound(k, m,
                                                          directed=directed))
    return torch.randn((m, f), generator=g, device=dev), idx, wl


@pytest.mark.cuda
@pytest.mark.parametrize("m,f,k,directed", [(16, 4096, 4, True),
                                            (16, 1001, 4, True),
                                            (37, 130, 3, False),
                                            (300, 2052, 10, True)])
def test_gossip_mix_kernel_bitwise_equals_plain(cuda, m, f, k, directed):
    """Bitwise: both take the slots in order with one FMA each (F = 1001
    and 130 take the phased path, the others the 16-byte one)."""
    x, idx, w = _gossip_case(m, f, k, m + f, cuda, directed=directed)
    got = ops.gossip_mix(x, idx, w)
    want = ops.gossip_mix(x, idx, w, impl="plain")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 2, 3, 5, 6, 7, 130, 1001, 1003, 5130])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_gossip_mix_kernel_phased_path_bitwise(cuda, f, offset):
    """F not a multiple of 4, or x starting `offset` floats past a 16-byte
    boundary: the phased path (a head and a tail one column at a time,
    the body's source rows read by 16-, 8- or 4-byte loads as their phase
    gives), bitwise against the plain version. offset 0 with F = 5130 is
    the packed fabric's header; F = 1..3 leaves some rows no body."""
    _, idx, w = _gossip_case(37, f, 3, f + offset, cuda, directed=False)
    g = torch.Generator(device=cuda).manual_seed(offset)
    x = torch.randn(37 * f + offset, generator=g, device=cuda)[offset:] \
        .view(37, f)
    assert x.data_ptr() % 16 == 4 * offset
    got = ops.gossip_mix(x, idx, w)
    want = ops.gossip_mix(x, idx, w, impl="plain")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 10), (16, 64), (16, 3, 3, 64, 64),
                                   (5, 700001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ties", [False, True])
def test_mask_evolve_kernel_bitwise_equals_plain(cuda, shape, dtype, ties):
    """Threshold, mask and output bits equal (signed zeros count), with
    keep = n/2, 1 and n."""
    from repro_torch.kernels.mask_evolve import (mask_evolve_cuda,
                                                 mask_evolve_plain)

    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda)
    if ties:
        x = (x * 4).round() / 4
    x = x.to(dtype)
    grow = torch.rand(shape, generator=g, device=cuda) > 0.98
    n = x.numel()
    for keep in (max(n // 2, 1), 1, n):
        out, mask, thr = mask_evolve_cuda(x, grow, keep=keep)
        p_out, p_mask, p_thr = mask_evolve_plain(x, grow, keep=keep)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(thr.view(torch.int32), p_thr.view(torch.int32))
        assert torch.equal(mask, p_mask)
        assert torch.equal(out.view(bits), p_out.view(bits))


@pytest.mark.cuda
def test_new_kernels_count_launches_and_refuse_bad_input(cuda):
    ops.reset_launch_counts()
    x, idx, w = _gossip_case(8, 64, 2, 0, cuda)
    ops.gossip_mix(x, idx, w)
    leaf = torch.randn(8, 33, device=cuda)
    ops.mask_evolve(leaf, torch.zeros_like(leaf, dtype=torch.bool), keep=100)
    assert ops.launch_counts() == {"flash_attention": 0, "gossip_mix": 1,
                                   "mask_evolve": 1, "raw_gram": 0,
                                   "select_topk": 0, "wkv_chunked": 0}
    from repro_torch.kernels.gossip_mix import gossip_mix_cuda
    from repro_torch.kernels.mask_evolve import mask_evolve_cuda

    with pytest.raises(ValueError):
        gossip_mix_cuda(x, idx.long(), w)
    with pytest.raises(ValueError):
        mask_evolve_cuda(leaf.half(), torch.zeros_like(leaf, dtype=torch.bool),
                         keep=3)
    with pytest.raises(ValueError):
        mask_evolve_cuda(leaf, torch.zeros_like(leaf, dtype=torch.bool),
                         keep=0)


def _evolve_leaves(dev):
    """A mixed list: float32 and bfloat16 leaves of 1 to 700,001 elements,
    one with ties, one with ±0, one with ±inf, one an unaligned view (the
    kernel's scalar loop), two (float32, bfloat16) with NaNs of both signs
    covering the kth position (the threshold is the bisection's NaN end)
    and two of subnormal magnitudes (a subnormal threshold); grow =
    uniform > 0.98."""
    g = torch.Generator(device=dev).manual_seed(7)
    leaves = []
    for i, (n, dtype) in enumerate([
            (1, torch.float32), (10, torch.bfloat16), (64, torch.float32),
            (4097, torch.bfloat16), (700_001, torch.float32),
            (700_001, torch.bfloat16), (65_536, torch.float32),
            (3001, torch.bfloat16), (5000, torch.float32),
            (1001, torch.bfloat16), (20_000, torch.float32),
            (20_001, torch.bfloat16), (3000, torch.float32),
            (30_000, torch.bfloat16)]):
        x = torch.randn(n + 1, generator=g, device=dev)
        if i == 3:
            x = (x * 4).round() / 4                    # ties
        if i == 6:
            x[::3] = 0.0
            x[1::3] = -0.0                             # ±0
        if i == 7:
            x[::5] = torch.inf
            x[1::9] = -torch.inf                       # ±inf
        if i in (10, 11):
            x[::8] = torch.nan
            x[4::8] = -torch.nan                       # 1/4 NaN
        if i in (12, 13):
            x = x * 1e-39                              # subnormal |x|
            x[::7] = 0.0
        x = x.to(dtype)
        leaves.append(x[1:] if i == 9 else x[:n].clone())
    grows = [torch.rand(x.shape, generator=g, device=dev) > 0.98
             for x in leaves]
    keeps = [max(x.numel() // 2, 1) for x in leaves]
    keeps[4], keeps[5] = 1, leaves[5].numel()
    keeps[10], keeps[11] = 20_000 // 8, 20_001 // 8   # kth in the NaNs
    return leaves, grows, keeps


def _same_bits(a, b):
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(bits), b.view(bits))


@pytest.mark.cuda
def test_mask_evolve_leaves_kernel_bitwise_equals_plain(cuda):
    """One call over a mixed list: each leaf's threshold, mask and output
    bits equal the plain version's (signed zeros count), and a second call
    equals the first bitwise (integer counters only)."""
    from repro_torch.kernels.mask_evolve import (NAN_END_BITS,
                                                 mask_evolve_leaves_cuda,
                                                 mask_evolve_plain)

    leaves, grows, keeps = _evolve_leaves(cuda)
    assert leaves[9].data_ptr() % 16 != 0
    got = mask_evolve_leaves_cuda(leaves, grows, keeps)
    again = mask_evolve_leaves_cuda(leaves, grows, keeps)
    for x, grow, keep, (out, mask, thr), (out2, mask2, thr2) in zip(
            leaves, grows, keeps, got, again):
        p_out, p_mask, p_thr = mask_evolve_plain(x, grow, keep=keep)
        assert _same_bits(thr, p_thr), (x.numel(), x.dtype)
        assert torch.equal(mask, p_mask), (x.numel(), x.dtype)
        assert _same_bits(out, p_out), (x.numel(), x.dtype)
        assert _same_bits(thr2, thr) and torch.equal(mask2, mask)
        assert _same_bits(out2, out)
    # the edge leaves reach the cases they are there for
    thr_bits = [int(t.view(torch.int32)) for _, _, t in got]
    assert thr_bits[10] == thr_bits[11] == NAN_END_BITS
    assert 0 < thr_bits[12] < 0x00800000 and 0 < thr_bits[13] < 0x00800000


@pytest.mark.cuda
def test_mask_evolve_leaves_counts_calls_and_leaves_and_refuses_bad_input(
        cuda):
    """A call counts one launch and its leaves, whatever their number; the
    one-leaf entry point is its one-leaf case; bad input raises
    ValueError before any launch."""
    from repro_torch.kernels.mask_evolve import (mask_evolve_cuda,
                                                 mask_evolve_leaves_cuda)

    leaves, grows, keeps = _evolve_leaves(cuda)
    ops.reset_launch_counts()
    fn = ops.KERNELS["mask_evolve"]
    assert (fn.launches, fn.leaves) == (0, 0)
    ops.mask_evolve_leaves(leaves, grows, keeps)
    assert (fn.launches, fn.leaves) == (1, len(leaves))
    mask_evolve_cuda(leaves[0], grows[0], keep=1)
    assert (fn.launches, fn.leaves) == (2, len(leaves) + 1)
    x, g = leaves[2], grows[2]
    for bad in ([], [x.half()], [x.cpu()]):
        with pytest.raises(ValueError):
            mask_evolve_leaves_cuda(bad, [g] * len(bad), [3] * len(bad))
    with pytest.raises(ValueError):
        mask_evolve_leaves_cuda([x, x], [g], [3, 3])
    with pytest.raises(ValueError):
        mask_evolve_leaves_cuda([x], [g], [x.numel() + 1])
    with pytest.raises(ValueError):
        mask_evolve_leaves_cuda([x], [g[:-1]], [3])
    with pytest.raises(ValueError):
        mask_evolve_leaves_cuda([x], [g.float()], [3])
    assert (fn.launches, fn.leaves) == (2, len(leaves) + 1)


# (B, Sq, Skv, H, K, hd, causal, window, q_offset)
FLASH_CASES = [(2, 200, 200, 12, 2, 128, True, 0, 0),
               (1, 77, 130, 4, 4, 64, True, 16, 53),
               (1, 50, 90, 6, 3, 64, False, 0, 0),
               (1, 33, 160, 6, 1, 128, True, 0, 127),
               (1, 16, 16, 2, 2, 64, True, 4, -8)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    """f32 (FFMA kernel): within 1e-5 of max(1, max|out|); bf16 and f16
    (wgmma kernel, P split into hi + lo): within one ulp of the dtype
    (plus 1e-5 of the scale near zero)."""
    from repro_torch.kernels import ref

    b, sq, skv, h, kh, hd, causal, window, q_offset = case
    g = torch.Generator(device=cuda).manual_seed(sum(case))
    q = torch.randn((b, sq, h, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, skv, kh, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, skv, kh, hd), generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, impl="plain", **kw)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-5 * scale
    else:
        assert ref.within_ulps(got, want)


# hd 256 (its own instances) and head dims padded to the next instance;
# (1, 4096, 4096, 10, 1, 256, True, 2048, 0) is recurrentgemma-2b's
# attention shape
FLASH_HEAD_DIM_CASES = [(1, 300, 300, 10, 1, 256, True, 2048, 0),
                        (1, 1100, 1100, 4, 1, 256, True, 300, 0),
                        (2, 130, 200, 4, 2, 256, False, 0, 0),
                        (1, 77, 130, 4, 4, 96, True, 16, 53),
                        (1, 200, 200, 4, 2, 32, True, 0, 0),
                        (1, 90, 90, 2, 1, 200, True, 0, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_HEAD_DIM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_kernel_matches_plain_at_other_head_dims(cuda, case,
                                                                 dtype):
    """hd 256 on both routes, and hd 32, 96 and 200 zero-padded to the
    next instance, against the unpadded plain version: f32 within 1e-5 of
    max(1, max|out|), bf16 and f16 within one ulp of the dtype; one
    launch of the dtype's route a call."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    b, sq, skv, h, kh, hd, causal, window, q_offset = case
    g = torch.Generator(device=cuda).manual_seed(sum(case))
    q = torch.randn((b, sq, h, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, skv, kh, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, skv, kh, hd), generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    routes = dict(fa.flash_attention_cuda.route_launches)
    got = ops.flash_attention(q, k, v, **kw)
    routes = {r: n - routes[r]
              for r, n in fa.flash_attention_cuda.route_launches.items()}
    assert routes[fa.ROUTES[dtype]] == 1 and sum(routes.values()) == 1
    want = ops.flash_attention(q, k, v, impl="plain", **kw)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-5 * scale
    else:
        assert ref.within_ulps(got, want)


@pytest.mark.cuda
def test_flash_attention_routes_by_dtype(cuda):
    """bf16 and f16 reach the wgmma kernel, f32 the FFMA kernel; a bf16
    view TMA cannot address as it lies is copied and reaches the wgmma
    kernel too, never another kernel."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    ops.reset_launch_counts()
    q = torch.randn(1, 70, 4, 64, device=cuda)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        t = q.to(dtype)
        ops.flash_attention(t, t[:, :, :2], t[:, :, :2])
    assert flash_attention_cuda.route_launches == {"ffma": 1, "wgmma": 2}
    assert ops.launch_counts()["flash_attention"] == 3
    flat = torch.randn(70 * 4 * 64 + 1, device=cuda).to(torch.bfloat16)
    odd = flat[1:].view(1, 70, 4, 64)                  # 2-byte aligned
    flash_attention_cuda(odd, odd, odd)
    assert flash_attention_cuda.route_launches == {"ffma": 1, "wgmma": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q", "k", "v", "qkv"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_unaligned_view_takes_wgmma(cuda, which, dtype):
    """A contiguous view at a 1-element offset (2-byte aligned) goes
    through the wgmma route and agrees with the plain version within one
    ulp of the dtype, as an aligned tensor does."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    g = torch.Generator(device=cuda).manual_seed(5)
    shape = (1, 200, 4, 64)
    n = 200 * 4 * 64
    ts = {}
    for name in "qkv":
        flat = torch.randn(n + 1, generator=g, device=cuda).to(dtype)
        ts[name] = (flat[1:] if name in which else flat[:n]).view(shape)
    assert all((ts[c].data_ptr() % 16 != 0) == (c in which) for c in "qkv")
    before = flash_attention_cuda.route_launches["wgmma"]
    got = ops.flash_attention(ts["q"], ts["k"], ts["v"], window=50)
    assert flash_attention_cuda.route_launches["wgmma"] == before + 1
    want = ops.flash_attention(ts["q"], ts["k"], ts["v"], window=50,
                               impl="plain")
    assert ref.within_ulps(got, want)


# (B, S, H, dtype of r/k/v, initial state, highest log-log decay, decays):
# decays "zero" sets w = 0 in a quarter of the channels (the reference
# clamps it to 1e-38), "one" sets w = 1 everywhere, "draw" keeps the draw
# w = exp(−exp(U[−6, hi])); hi = 4.5 reaches w = e^{−90}
WKV_CASES = [(2, 150, 3, "float32", True, 1.0, "draw"),
             (1, 37, 2, "float32", False, -1.0, "draw"),
             (2, 200, 4, "bfloat16", True, -1.0, "draw"),
             (1, 5, 2, "float32", True, 1.0, "draw"),
             (2, 150, 4, "float16", True, 1.0, "draw")]
WKV_EDGE_CASES = [(2, 150, 2, "float32", True, 4.5, "draw"),
                  (1, 300, 2, "float32", True, 1.0, "zero"),
                  (2, 200, 4, "bfloat16", True, 4.5, "zero"),
                  (1, 100, 2, "float32", True, 1.0, "one")]


def _wkv_card_inputs(case, dev):
    """r, k, v, w, u and the initial state (or None) of a WKV case."""
    b, s, h, dtype, state, hi, decays = case
    g = torch.Generator(device=dev).manual_seed(s + h)
    r, k, v = (torch.randn((b, s, h, 64), generator=g, device=dev)
               .to(getattr(torch, dtype)) for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand((b, s, h, 64), generator=g,
                                        device=dev) * (hi + 6.0) - 6.0))
    if decays == "zero":
        w[..., ::4] = 0.0
    elif decays == "one":
        w.fill_(1.0)
    u = torch.randn((h, 64), generator=g, device=dev) * 0.3
    s0 = torch.randn((b, h, 64, 64), generator=g, device=dev) if state \
        else None
    return r, k, v, w, u, s0


def _wkv_agrees(out, sf, want, want_s):
    """Output within 1e-4 of max|out| (f32) or one ulp of the 16-bit
    dtype (bf16, f16); final state within 1e-5 of max|S|."""
    from repro_torch.kernels import ref

    if out.dtype == torch.float32:
        ok = float((out - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
    else:
        ok = ref.within_ulps(out, want)
    return ok and float((sf - want_s).abs().max()) <= \
        1e-5 * float(want_s.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv_chunked_kernel_matches_plain(cuda, case):
    """Output within 1e-4 of max|out| (f32) or one ulp (bf16, f16); final
    state within 1e-5 of max|S|."""
    inputs = _wkv_card_inputs(case, cuda)
    out, sf = ops.wkv(*inputs)
    p_out, p_sf = ops.wkv(*inputs, impl="plain")
    assert out.dtype == inputs[0].dtype and sf.dtype == torch.float32
    assert _wkv_agrees(out, sf, p_out, p_sf)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV_EDGE_CASES)
def test_wkv_chunked_kernel_matches_oracle_at_extreme_decay(cuda, case):
    """w = 0 (the reference clamps it to 1e-38), w down to e^{−90}, and
    w = 1: output within 1e-4 of max|out| (f32) or one bf16 ulp, state
    within 1e-5 of max|S|, against the per-token recurrence `wkv_ref`.
    The plain version is no yardstick here: its e^{cum_prev − cum} of
    log-w prefix sums is off by ~ε·|cum| (|cum| up to 64·87.5), beyond
    these tolerances (chip_smoke.py phase 2 prints the distance)."""
    from repro_torch.kernels import ref

    inputs = _wkv_card_inputs(case, cuda)
    out, sf = ops.wkv(*inputs)
    o_out, o_sf = ref.wkv_ref(*inputs)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(sf).all())
    assert _wkv_agrees(out, sf, o_out, o_sf)


@pytest.mark.cuda
def test_wkv_chunked_kernel_takes_unaligned_views(cuda):
    """r, k, v, w and the state as views at a 1-element offset are copied
    and give the aligned inputs' result bitwise."""
    g = torch.Generator(device=cuda).manual_seed(3)
    shape, n = (1, 130, 2, 64), 130 * 2 * 64
    flats = [torch.randn(n + 1, generator=g, device=cuda) for _ in range(4)]
    flats[3] = flats[3].sigmoid()
    s_flat = torch.randn(2 * 64 * 64 + 1, generator=g, device=cuda)
    u = torch.randn((2, 64), generator=g, device=cuda)
    odd = [f[1:].view(shape) for f in flats]
    even = [t.clone() for t in odd]
    s_odd = s_flat[1:].view(1, 2, 64, 64)
    got = ops.wkv(*odd, u, s_odd)
    want = ops.wkv(*even, u, s_odd.clone())
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_serving_kernels_count_launches_and_refuse_bad_input(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.wkv_chunked import wkv_chunked_cuda

    ops.reset_launch_counts()
    q = torch.randn(1, 70, 4, 64, device=cuda)
    ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    r = torch.randn(1, 70, 2, 64, device=cuda)
    ops.wkv(r, r, r, torch.rand_like(r), torch.zeros(2, 64, device=cuda))
    assert ops.launch_counts() == {"flash_attention": 1, "gossip_mix": 0,
                                   "mask_evolve": 0, "raw_gram": 0,
                                   "select_topk": 0, "wkv_chunked": 1}
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q.half(), q)           # mixed dtypes
    wide = torch.randn(1, 70, 4, 320, device=cuda)
    with pytest.raises(ValueError):
        flash_attention_cuda(wide, wide, wide)           # head_dim > 256
    with pytest.raises(ValueError, match="v head dim"):
        flash_attention_cuda(q, q, torch.cat([q, q], -1))  # dv > hd
    with pytest.raises(ValueError):
        wkv_chunked_cuda(r, r, r, r.half(), torch.zeros(2, 64, device=cuda))
    with pytest.raises(ValueError):
        wkv_chunked_cuda(r, r, r, r, torch.zeros(3, 64, device=cuda))


# ---------------------------------------------------------------------------
# the comms fabric's inputs to the kernels
# ---------------------------------------------------------------------------

def _fabric(topo, m, dev, **kw):
    from repro_torch.comms import make_fabric
    from repro_torch.configs import CommsConfig

    return make_fabric(CommsConfig(topology=topo, link_model="hetero",
                                   p_link_drop=0.1, availability=0.9,
                                   p_stale=0.1, **kw), m, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("topo,m,k", [("ring", 16, 4), ("torus", 300, 4),
                                      ("erdos_renyi", 1024, 10)])
def test_select_topk_kernel_takes_fabric_candidates_and_costs(cuda, topo, m,
                                                              k):
    """A fabric round's candidate mask and hetero (M, M) cost matrix, as a
    pfeddst round on a fabric passes them: indices exact against the
    plain version, values rtol 1e-4."""
    from repro_torch.fl.engine import net_streams

    fab = _fabric(topo, m, cuda, ring_hops=3)
    cand, _, _ = fab.round_masks(net_streams((m, 0)))
    x, last, s_l, t, _, _ = _case(m, 513, m, cuda, matrix_cost=False,
                                  cand=False)
    args = (x, last, s_l, t, fab.cost, cand)
    v, i, s = ops.select_topk(*args, k=k, alpha=ALPHA, lam=LAM)
    pv, pi, ps = ops.select_topk(*args, k=k, alpha=ALPHA, lam=LAM,
                                 impl="plain")
    assert torch.equal(i, pi)
    torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s, ps, rtol=1e-4, atol=1e-6 * m)


@pytest.mark.cuda
@pytest.mark.parametrize("m,f", [(16, 70001), (65536, 64)])
def test_gossip_mix_kernel_bitwise_at_packed_ring_shapes(cuda, m, f):
    """The fabric's new gossip_mix shapes, bitwise against the plain
    version: an undirected plan on a ring (the topology bound D = 3, as
    dfedavgm and dispfl pack it), and the packed fabric's mix at
    M = 65536 (self and k = 4 picks from hier_ring neighbour lists)."""
    from repro_torch.core.aggregation import selection_to_weights
    from repro_torch.fl.engine import gossip_edges, net_streams
    from repro_torch.kernels.gossip_mix import (gossip_degree_bound,
                                                weights_to_neighbors)

    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn((m, f), generator=g, device=cuda)
    if m <= 16:
        fab = _fabric("ring", m, cuda)
        cand, _, _ = fab.round_masks(net_streams((1, 0)))
        mask = gossip_edges(torch.rand((m, m), generator=g, device=cuda), 4,
                            directed=False, cand=cand)
        d = gossip_degree_bound(4, m, directed=False, topo_degree=2)
        idx, w = weights_to_neighbors(
            selection_to_weights(mask, include_self=True), d)
        assert d == 3 and torch.equal(
            (w != 0).sum(1), mask.sum(1) + 1)
    else:
        fab = _fabric("hier_ring", m, cuda, sparse=True)
        slots, _, _ = fab.round_slots(net_streams((1, 0)))
        sel = slots & (torch.rand(slots.shape, generator=g, device=cuda)
                       < 0.8)
        inv = 1.0 / (sel.sum(1, keepdim=True) + 1.0)
        rows = torch.arange(m, device=cuda, dtype=torch.int32)[:, None]
        idx = torch.cat([rows, torch.where(sel, fab.nbr_idx, rows)], 1)
        w = torch.cat([inv, torch.where(sel, inv, 0.0)], 1)
        assert idx.shape == (m, 5)
    got = ops.gossip_mix(x, idx, w)
    want = ops.gossip_mix(x, idx, w, impl="plain")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pfeddst", "dfedavgm"])
def test_fabric_rounds_on_card_agree_with_cpu(cuda, name):
    """Two rounds on a ring with hetero links and events, on the card (the
    kernels: select_topk with candidates and the cost matrix; the packed
    gossip_mix at D = 3) and on the CPU (plain versions, dense mix) from
    the same state and draws: masks and edges exact, the loss matrix and
    the parameters within rtol 1e-3."""
    import dataclasses

    from repro_torch.configs import CommsConfig, FLConfig, get_config
    from repro_torch.data.synthetic import client_datasets_cifar
    from repro_torch.fl.strategies import make_strategy
    from repro_torch.utils.pytree import tree_map

    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=8, cnn_width=32)
    data = client_datasets_cifar(1, 6, samples_per_class=20, image_size=8)
    train = {"images": data["train_x"], "labels": data["train_y"]}
    net = CommsConfig(topology="ring", ring_hops=2 if name == "pfeddst"
                      else 1, link_model="hetero", p_link_drop=0.1,
                      availability=0.9, p_stale=0.1)
    fl = FLConfig(num_clients=6, peers_per_round=2, batch_size=8,
                  client_sample_ratio=0.5, epochs_extractor=1,
                  epochs_header=1, probe_size=4, use_score_kernel=True,
                  comms=net)
    cpu = make_strategy(name, cfg, fl, 1, device="cpu")
    gpu = make_strategy(name, cfg, fl, 1, device=cuda)
    assert gpu.fabric.cost.device.type == cuda.type
    cpu_state = cpu.init(3)
    def move(t):
        return t.to(cuda) if t.dim() else t

    gpu_state = (type(cpu_state)(*(tree_map(move, v) for v in cpu_state))
                 if name == "pfeddst" else tree_map(move, cpu_state))
    gpu_train = {k: v.to(cuda) for k, v in train.items()}
    edges = "select_mask" if name == "pfeddst" else "comm_edges"
    ops.reset_launch_counts()
    for r in range(2):
        cpu_state, cm = cpu.round(cpu_state, train, (7, r))
        gpu_state, gm = gpu.round(gpu_state, gpu_train, (7, r))
        assert torch.equal(cm[edges], gm[edges].cpu())
        assert torch.equal(cm["stale"], gm["stale"].cpu())
    kernel = "select_topk" if name == "pfeddst" else "gossip_mix"
    assert ops.launch_counts()[kernel] == 2
    pairs = ((cpu_state.loss_matrix, gpu_state.loss_matrix)
             if name == "pfeddst" else
             zip(cpu_state["params"].values(), gpu_state["params"].values()))
    for want, got in ([pairs] if name == "pfeddst" else pairs):
        scale = float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3,
                                   atol=max(1e-4, 1e-3 * scale))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 4])
def test_peer_store_serve_and_publish_on_card_bitwise_equal_cpu(cuda, depth):
    """The versioned peer store on CUDA tensors (bf16 and f32 leaves, the
    paper's dtypes and the parity tests'): eight rounds of publishes and
    serves with event lags up to 6 (clipped to V − 1), from round 0 (slot
    −1 mod V) through ring wraparounds, bitwise equal to the same store
    on the CPU; the slots are written in place."""
    from repro_torch.fl import hetero

    m = 16
    g = torch.Generator().manual_seed(depth)

    def tree():
        return {"e": {"w": torch.randn(m, 3, 3, 8, generator=g).to(
                    torch.bfloat16)},
                "h": {"b": torch.randn(m, 10, generator=g)}}

    def on_card(t):
        return {k: {n: x.to(cuda) for n, x in d.items()}
                for k, d in t.items()}

    first = tree()
    cpu = hetero.init_peer_store(first, depth)
    gpu = hetero.init_peer_store(on_card(first), depth)
    slots = gpu.params["e"]["w"]

    def same(a, b):
        a, b = a.cpu(), b
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        return torch.equal(a, b)

    for rnd in range(8):
        lag = torch.randint(0, 7, (m,), generator=g, dtype=torch.int32)
        for ev in (None, lag):
            cs, ca = hetero.store_serve(cpu, rnd, ev)
            gs, ga = hetero.store_serve(gpu, rnd, None if ev is None
                                        else ev.to(cuda))
            assert torch.equal(ga.cpu(), ca)
            for k in cs:
                for n in cs[k]:
                    assert same(gs[k][n], cs[k][n]), (rnd, k, n)
        new = tree()
        fresh = torch.rand(m, generator=g) < 0.5
        blocked = ~fresh & (torch.rand(m, generator=g) < 0.5)
        cpu = hetero.store_publish(cpu, new, fresh, blocked, rnd)
        gpu = hetero.store_publish(gpu, on_card(new), fresh.to(cuda),
                                   blocked.to(cuda), rnd)
        assert gpu.params["e"]["w"] is slots
        assert torch.equal(gpu.pub_round.cpu(), cpu.pub_round)
        assert torch.equal(gpu.lag.cpu(), cpu.lag)
        for k in cpu.params:
            for n in cpu.params[k]:
                assert same(gpu.params[k][n], cpu.params[k][n])


@pytest.mark.cuda
def test_async_rounds_launch_select_topk_on_served_headers(cuda,
                                                           monkeypatch):
    """Two pfeddst_async rounds (bimodal profile, 1 s deadline, a ring
    with staleness events served from the store) on the card and on the
    CPU from the same state and keys: select_topk launched once a round
    on the card, given the served headers (the live rows of this round's
    participants, the store's slots for the others), the candidate mask
    and the cost matrix; masks, active sets and the store's counters
    exact, the loss matrix within rtol 1e-3."""
    import dataclasses

    from repro_torch.configs import (CommsConfig, DeviceProfile, FLConfig,
                                     get_config)
    from repro_torch.core.scoring import flatten_headers
    from repro_torch.data.synthetic import client_datasets_cifar
    from repro_torch.fl import hetero
    from repro_torch.fl.engine import where_tree
    from repro_torch.fl.strategies import make_strategy
    from repro_torch.utils.pytree import tree_map

    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=8, cnn_width=32)
    data = client_datasets_cifar(1, 6, samples_per_class=20, image_size=8)
    train = {"images": data["train_x"], "labels": data["train_y"]}
    fl = FLConfig(num_clients=6, peers_per_round=2, batch_size=8,
                  client_sample_ratio=0.5, epochs_extractor=1,
                  epochs_header=1, probe_size=4, use_score_kernel=True,
                  device_profile=DeviceProfile(family="bimodal",
                                               straggler_fraction=0.5),
                  deadline_s=1.0,
                  comms=CommsConfig(topology="ring", ring_hops=2,
                                    link_model="hetero", p_stale=0.4,
                                    stale_mode="serve"))
    cpu = make_strategy("pfeddst_async", cfg, fl, 1, device="cpu")
    gpu = make_strategy("pfeddst_async", cfg, fl, 1, device=cuda)
    cpu_state = cpu.init(3)
    fields = cpu_state._asdict()
    store = fields.pop("store")

    def move(t):
        return t.to(cuda) if t.dim() else t.clone()

    gpu_state = type(cpu_state)(
        **{k: tree_map(move, v) for k, v in fields.items()},
        store=hetero.PeerStore(*(tree_map(move, v) for v in store)))
    gpu_train = {k: v.to(cuda) for k, v in train.items()}
    calls = []
    original = ops.select_topk

    def spy(x, last, s_l, t, cost, cand=None, **kw):
        if x.is_cuda:
            calls.append((x.clone(), isinstance(cost, torch.Tensor)
                          and cost.dim() == 2, cand is not None))
        return original(x, last, s_l, t, cost, cand, **kw)

    monkeypatch.setattr(ops, "select_topk", spy)
    ops.reset_launch_counts()
    for r in range(2):
        # the round writes its store in place: keep the ring it serves from
        before = gpu_state
        ring = hetero.PeerStore(*(tree_map(torch.clone, v)
                                  for v in gpu_state.store))
        cpu_state, cm = cpu.round(cpu_state, train, (7, r))
        gpu_state, gm = gpu.round(gpu_state, gpu_train, (7, r))
        for k in ("active", "select_mask", "stale"):
            assert torch.equal(cm[k], gm[k].cpu()), k
        assert ops.launch_counts()["select_topk"] == r + 1
        x, matrix_cost, cand = calls[-1]
        assert matrix_cost and cand
        served, _ = hetero.store_serve(ring, int(before.round), gm["stale"])
        view = where_tree(gm["active"], before.header, served["h"])
        assert torch.equal(x, flatten_headers(view))
        assert torch.equal(gpu_state.store.lag.cpu(), cpu_state.store.lag)
        assert torch.equal(gpu_state.store.pub_round.cpu(),
                           cpu_state.store.pub_round)
        want = cpu_state.loss_matrix
        torch.testing.assert_close(
            gpu_state.loss_matrix.cpu(), want, rtol=1e-3,
            atol=max(1e-4, 1e-3 * float(want.abs().max())))


# ---------------------------------------------------------------------------
# the open world and checkpoints on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_attacked_defended_pfeddst_round_median_bitwise_cpu(cuda,
                                                            monkeypatch):
    """One pfeddst round under sign_flip with score gaming and the median
    defense on the card: select_topk launched with the (M, M) spoofed
    cost, and the card's median aggregate bitwise equal to the CPU's on
    the same tensors."""
    import dataclasses

    from repro_torch.configs import FLConfig, ThreatConfig, get_config
    from repro_torch.core import rounds as rounds_mod
    from repro_torch.data.synthetic import client_datasets_cifar
    from repro_torch.fl.strategies import make_strategy

    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="bfloat16", image_size=8)
    data = client_datasets_cifar(1, 8, samples_per_class=10, image_size=8)
    train = {"images": data["train_x"].to(cuda),
             "labels": data["train_y"].to(cuda)}
    fl = FLConfig(num_clients=8, peers_per_round=2, batch_size=8,
                  client_sample_ratio=0.5, epochs_extractor=1,
                  epochs_header=1, probe_size=4, use_score_kernel=True,
                  threat=ThreatConfig(adversary_fraction=0.25,
                                      attack="sign_flip", score_game="both",
                                      defense="median"))
    strat = make_strategy("pfeddst", cfg, fl, 1, device=cuda)
    real = rounds_mod.robust_row_aggregate
    checked = []

    def spy(tree, edges, weights, m, **kw):
        out = real(tree, edges, weights, m, **kw)
        want = real({n: t.cpu() for n, t in tree.items()}, edges.cpu(),
                    weights.cpu(), m, **kw)
        for n, t in out.items():
            assert t.is_cuda and torch.equal(t.cpu(), want[n]), n
        checked.append(len(out))
        return out

    monkeypatch.setattr(rounds_mod, "robust_row_aggregate", spy)
    ops.reset_launch_counts()
    state, met = strat.round(strat.init(0), train, (0, 0))
    assert checked and ops.launch_counts()["select_topk"] == 1
    assert set(state) == {"inner", "alive"}
    assert torch.isfinite(met["adv_isolation"]).all()


@pytest.mark.cuda
def test_checkpoint_roundtrip_of_card_tensors(cuda, tmp_path):
    """bf16, f32, int32 and bool tensors on the card save and restore onto
    the card bit for bit."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn(64, 33, generator=g, device=cuda).to(
                torch.bfloat16),
            "nested": {"b": torch.randn(7, generator=g, device=cuda),
                       "i": torch.arange(5, device=cuda,
                                         dtype=torch.int32)},
            "list": [torch.rand(3, 3, generator=g, device=cuda) > 0.5]}
    path = save_checkpoint(str(tmp_path), 1, tree)
    got, _ = load_checkpoint(path, like=tree)
    for a, b in ((got["w"], tree["w"]), (got["nested"]["b"],
                                         tree["nested"]["b"]),
                 (got["nested"]["i"], tree["nested"]["i"]),
                 (got["list"][0], tree["list"][0])):
        assert a.is_cuda and a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_checkpoint_restore_keeps_host_scalars_on_the_host(cuda, tmp_path):
    """A PopulationState on the card restores onto the card, its round
    (kept on the host by design) onto the host."""
    import dataclasses

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.fl.strategies import make_strategy
    from repro_torch.utils.pytree import tree_paths

    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              image_size=8)
    state = make_strategy("pfeddst", cfg, FLConfig(num_clients=3), 1,
                          device=cuda).init(0)
    assert not state.round.is_cuda and state.loss_matrix.is_cuda
    got, _ = load_checkpoint(save_checkpoint(str(tmp_path), 0, state),
                             like=state)
    for (_, a), (_, b) in zip(tree_paths(got), tree_paths(state)):
        assert a.device == b.device and a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b)


def _deterministic():
    """cuDNN deterministic and no benchmark (as chip_smoke's phase 7 (a)),
    restored on exit."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        flags = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            yield
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = flags

    return ctx()


@pytest.mark.cuda
def test_chunked_rounds_on_card_equal_per_round_rounds(cuda):
    """pfeddst with the score kernel at a small size: a 4-round
    make_multi_round chunk equals 4 make_round calls bitwise (state and
    every metric), select_topk launched once a round in each; and
    run_experiment(chunk_rounds=2) equals chunk_rounds=1 in every History
    field but the walls (its metrics reach the host in one packed copy)."""
    import dataclasses

    from repro_torch.configs import FLConfig, get_config
    from repro_torch.data.synthetic import client_datasets_cifar
    from repro_torch.fl import engine, simulator
    from repro_torch.fl.strategies import make_strategy
    from repro_torch.utils.pytree import tree_paths

    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=8)
    data = client_datasets_cifar(1, 6, samples_per_class=10, image_size=8)
    train = {"images": data["train_x"].to(cuda),
             "labels": data["train_y"].to(cuda)}
    fl = FLConfig(num_clients=6, peers_per_round=2, batch_size=8,
                  client_sample_ratio=0.5, epochs_extractor=1,
                  epochs_header=1, probe_size=4, use_score_kernel=True)
    strat = make_strategy("pfeddst", cfg, fl, 1, device=cuda)
    with _deterministic():
        ops.reset_launch_counts()
        state, mets = strat.init(1), []
        for r in range(4):
            state, met = strat.round(state, train, (3, r))
            mets.append(met)
        assert ops.launch_counts()["select_topk"] == 4
        ops.reset_launch_counts()
        fn = engine.make_multi_round(strat.spec, fl, strat.fabric,
                                     chunk_rounds=4)
        chunk_state, stacked = fn(strat.init(1), train, 3, 0)
        assert ops.launch_counts()["select_topk"] == 4
        for (p, a), (_, b) in zip(tree_paths(chunk_state),
                                  tree_paths(state)):
            assert torch.equal(a, b), p
        host = engine.metrics_to_host(stacked)
        for i, met in enumerate(engine.unstack_metrics(host, 4)):
            assert met.keys() == mets[i].keys()
            for k, v in met.items():
                assert v.device.type == "cpu"
                assert torch.equal(v, mets[i][k].cpu()), (i, k)
        hists = [simulator.run_experiment(
            "pfeddst", cfg, fl, data, num_rounds=4, eval_every=2,
            steps_per_epoch=1, verbose=False, device=cuda,
            chunk_rounds=chunk).to_dict() for chunk in (2, 1)]
    for key in set(hists[0]) - {"wall_s", "compile_s"}:
        assert hists[0][key] == hists[1][key], key


@pytest.mark.cuda
def test_driver_cli_runs_on_card(cuda, capsys):
    """The CLI's --device cuda path: 2 rounds of the reduced default
    (pfeddst and pfeddst_random, one chunk of 2 each)."""
    import math

    from repro_torch.examples import fl_cifar_sim

    hists = fl_cifar_sim.main(["--rounds", "2", "--device", "cuda"])
    assert set(hists) == {"pfeddst", "pfeddst_random"}
    for hist in hists.values():
        assert hist.rounds == [2]
        assert all(math.isfinite(x) for x in hist.accuracy + hist.train_loss)
    assert "final personalized accuracy" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the hybrid and audio families' serving path
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-base"])
def test_hybrid_and_encdec_prefill_on_card_agree_with_cpu(cuda, arch):
    """Reduced f32 recurrentgemma-2b (a 40-token prompt wraps the window of
    16 twice) and whisper-base (random frames), the same weights on both:
    the card's prefill (the flash kernel, once per attention layer) and
    the CPU's (the plain version) give logits and states within 1e-4 of
    their scale, and greedy tokens are equal."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import flatten_tree
    from repro_torch.launch.serve import generate
    from repro_torch.models import model
    from repro_torch.utils.pytree import tree_map

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = model.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    card = tree_map(lambda t: t.to(cuda), params)
    gen = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                     dtype=torch.int32, generator=gen)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                      generator=gen)
    want_logits, want_state = model.prefill(cfg, params, batch, max_seq=48)
    ops.reset_launch_counts()
    logits, state = model.prefill(cfg, card,
                                  tree_map(lambda t: t.to(cuda), batch),
                                  max_seq=48)
    n_attn = (cfg.block_pattern.count("attn") if cfg.family == "hybrid"
              else cfg.encoder_layers + 2 * cfg.num_layers)
    assert ops.launch_counts()["flash_attention"] == n_attn
    pairs = [(logits, want_logits)] + [
        (t, flatten_tree(want_state)[n])
        for n, t in flatten_tree(state).items()]
    for got, want in pairs:
        scale = max(1.0, float(want.abs().max()))
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
    toks = batch["tokens"]
    assert torch.equal(generate(cfg, card, toks.to(cuda), gen_tokens=6).cpu(),
                       generate(cfg, params, toks, gen_tokens=6))


@pytest.mark.cuda
def test_hybrid_bf16_prefill_takes_the_wgmma_hd256_route(cuda):
    """A bf16 hybrid at head_dim 256 (recurrentgemma-2b's) prefills its
    windowed attention on the wgmma kernel's hd-256 instance, once per
    attention layer, with finite logits."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model

    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                              head_dim=256)
    params = model.init_params(cfg, torch.Generator(device=cuda).manual_seed(
        0), cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 300), device=cuda,
                         dtype=torch.int32)
    ops.reset_launch_counts()
    logits, _ = model.prefill(cfg, params, {"tokens": toks}, max_seq=310)
    assert fa.flash_attention_cuda.route_launches == {
        "ffma": 0, "wgmma": cfg.block_pattern.count("attn")}
    assert bool(torch.isfinite(logits).all())


@pytest.mark.cuda
def test_lru_doubling_scan_on_card_matches_sequential_recurrence(cuda):
    """`rglru.linear_scan` (⌈log2 S⌉ doubling steps) on the card against
    h_t = a_t·h_{t−1} + b_t step by step in f64: within 1e-5 of the scale
    at S = 1000 (not a power of two), a in (0.9, 1)."""
    from repro_torch.models import rglru

    g = torch.Generator(device=cuda).manual_seed(1)
    a = 0.9 + 0.1 * torch.rand((2, 1000, 64), generator=g, device=cuda)
    b = torch.randn((2, 1000, 64), generator=g, device=cuda)
    got = rglru.linear_scan(a, b).double()
    h = torch.zeros((2, 64), dtype=torch.float64, device=cuda)
    for t in range(1000):
        h = a[:, t].double() * h + b[:, t].double()
        scale = max(1.0, float(h.abs().max()))
        assert float((got[:, t] - h).abs().max()) <= 1e-5 * scale, t


# (B, Sq, Skv, H, K, dqk, dv, causal): MLA's reduced 48/32 (the hd-64
# instance), and deepseek-v3's 192/128 (the hd-256 instance)
FLASH_DV_CASES = [(2, 300, 300, 4, 4, 48, 32, True),
                  (1, 200, 330, 4, 2, 48, 32, False),
                  (1, 520, 520, 8, 8, 192, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_DV_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_dv_below_dqk_matches_plain(cuda, case, dtype):
    """v's head dim below q/k's (MLA): the kernel on q, k and v
    zero-padded to the instance's head dim, cut back to dv, against the plain version taking dv directly:
    f32 within 1e-5 of max(1, max|out|), bf16 within one ulp; one launch
    of the dtype's route a call."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    b, sq, skv, h, kh, dqk, dv, causal = case
    g = torch.Generator(device=cuda).manual_seed(sum(case))
    q = torch.randn((b, sq, h, dqk), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, skv, kh, dqk), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, skv, kh, dv), generator=g, device=cuda).to(dtype)
    routes = dict(fa.flash_attention_cuda.route_launches)
    got = ops.flash_attention(q, k, v, causal=causal)
    routes = {r: n - routes[r]
              for r, n in fa.flash_attention_cuda.route_launches.items()}
    assert routes[fa.ROUTES[dtype]] == 1 and sum(routes.values()) == 1
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    assert got.shape == want.shape == (b, sq, h, dv) and got.dtype == dtype
    if dtype == torch.float32:
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-5 * scale
    else:
        assert ref.within_ulps(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"])
def test_moe_prefill_on_card_agrees_with_cpu_and_repeats(cuda, arch):
    """Reduced f32 phi3.5-moe and deepseek-v3 (MLA), the same weights on
    both devices: the card's prefill (flash once per layer) gives logits
    within 1e-4 of the CPU's scale, bitwise the same logits when run
    again, and the CPU's greedy tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import model
    from repro_torch.utils.pytree import tree_map

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = model.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    card = tree_map(lambda t: t.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 60), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(4))
    want, _ = model.prefill(cfg, params, {"tokens": toks}, max_seq=66)
    ops.reset_launch_counts()
    got, _ = model.prefill(cfg, card, {"tokens": toks.to(cuda)}, max_seq=66)
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    again, _ = model.prefill(cfg, card, {"tokens": toks.to(cuda)},
                             max_seq=66)
    assert torch.equal(got, again)
    scale = max(1.0, float(want.abs().max()))
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
    assert torch.equal(generate(cfg, card, toks.to(cuda), gen_tokens=6).cpu(),
                       generate(cfg, params, toks, gen_tokens=6))


# ---------------------------------------------------------------------------
# federated LLM training: the kernels at the LLM headers' width, the
# column-blocked mix, the in-place mask evolution, a reduced LLM round
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_select_topk_and_raw_gram_at_llm_header_width(cuda):
    """M = 4 rows of P = 2²⁷ + 5 columns (an LLM header's width class:
    qwen2-1.5b's is 2.3e8): select_topk's selection exact against the
    plain version and raw_gram's Gram within 1e-3 of its scale (f32 sums
    of 1.3e8 products in another order); the slice bounds stay below
    2³¹."""
    from repro_torch.core.selection import topk_to_mask

    m, p, k = 4, (1 << 27) + 5, 2
    args = _case(m, p, 31, cuda, matrix_cost=True, cand=True)
    v, i, s = ops.select_topk(*args, k=k, alpha=ALPHA, lam=LAM)
    pv, pi, ps = ops.select_topk(*args, k=k, alpha=ALPHA, lam=LAM,
                                 impl="plain")
    assert torch.equal(topk_to_mask(i, v, m), topk_to_mask(pi, pv, m))
    torch.testing.assert_close(v, pv, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(s, ps, rtol=1e-3, atol=1e-5 * m)
    got = ops.raw_gram(args[0])
    want = ops.raw_gram(args[0], impl="plain")
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    assert p < 2 ** 31


@pytest.mark.cuda
def test_blocked_gossip_mix_on_card_equals_one_call(cuda, monkeypatch):
    """`engine.mix_tree` over column blocks (a leaf cut across blocks)
    launches one gossip_mix a block and equals one call over the whole
    packed tree bit for bit; the in-place mix writes the active rows
    only."""
    from repro_torch.core.aggregation import selection_to_weights
    from repro_torch.fl import engine
    from repro_torch.kernels.gossip_mix import weights_to_neighbors

    g = torch.Generator(device=cuda).manual_seed(32)
    m = 4
    tree = {"a": torch.randn((m, 1000, 3), generator=g, device=cuda),
            "b": torch.randn((m, 777), generator=g,
                             device=cuda).to(torch.bfloat16)}
    nbr = engine.gossip_edges(torch.rand((m, m), generator=g, device=cuda),
                              2, directed=True)
    w = selection_to_weights(nbr, include_self=True)
    idx, wl = weights_to_neighbors(w, 3)
    plan = engine.ExchangePlan("p2p", active=torch.ones(
        m, dtype=torch.bool, device=cuda), weights=w, nbr_idx=idx, nbr_w=wl)
    whole = engine.mix_tree(tree, plan, m)
    monkeypatch.setattr(engine, "F32_BLOCK_COLUMNS", 1000)
    ops.reset_launch_counts()
    got = engine.mix_tree(tree, plan, m)
    assert ops.launch_counts()["gossip_mix"] == 4   # 3777 columns
    for a, b in zip(engine.tree_leaves(got), engine.tree_leaves(whole)):
        assert torch.equal(a, b)
    rows = torch.tensor([True, False, True, True], device=cuda)
    inplace = engine.tree_map(torch.clone, tree)
    engine.mix_tree(inplace, plan, m, rows=rows)
    for a, b, o in zip(engine.tree_leaves(inplace),
                       engine.tree_leaves(whole), engine.tree_leaves(tree)):
        assert torch.equal(a[rows], b[rows])
        assert torch.equal(a[~rows], o[~rows])


@pytest.mark.cuda
def test_mask_evolve_in_place_matches_plain(cuda):
    """One call over a list of leaves, each evolved into its own tensor
    and its mask into its grow plane, bitwise the plain version's."""
    from repro_torch.kernels import mask_evolve as me

    g = torch.Generator(device=cuda).manual_seed(33)
    leaves = [(torch.randn((4, 300, 7), generator=g, device=cuda) * 0.05
               ).to(dt) for dt in (torch.bfloat16, torch.float32)]
    grows = [torch.rand(x.shape, generator=g, device=cuda) > 0.98
             for x in leaves]
    keeps = [x.numel() // 2 for x in leaves]
    want = [me.mask_evolve_plain(x, gr, keep=k)
            for x, gr, k in zip(leaves, grows, keeps)]
    xs, gs = [x.clone() for x in leaves], [gr.clone() for gr in grows]
    done = ops.mask_evolve_leaves(xs, gs, keeps, in_place=True)
    for (out, mask), x, gr, (p_out, p_mask, _) in zip(done, xs, gs, want):
        assert out.data_ptr() == x.data_ptr()
        assert mask.data_ptr() == gr.data_ptr()
        assert torch.equal(mask, p_mask)
        bits = torch.int16 if out.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(out.view(bits), p_out.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pfeddst", "dfedpgp"])
def test_reduced_llm_round_on_card_agrees_with_cpu(cuda, name):
    """One round of `name` over reduced qwen2-1.5b in f32 (M = 4, k = 2,
    every client sampled; the population trains in place), on the card
    and on the CPU from the same initial state and draws: the selected
    edges equal, the parameters within 1e-4 of each leaf's scale."""
    import dataclasses

    from repro_torch.configs import FLConfig, get_config
    from repro_torch.fl.strategies import make_strategy

    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              dtype="float32")
    fl = FLConfig(num_clients=4, peers_per_round=2, batch_size=4,
                  client_sample_ratio=1.0, epochs_extractor=1,
                  probe_size=2, lr=0.05, use_score_kernel=True, comms=None)
    tokens = torch.randint(0, cfg.vocab_size, (4, 6, 16),
                           generator=torch.Generator().manual_seed(34))
    out = {}
    for dev in ("cpu", cuda):
        strat = make_strategy(name, cfg, fl, 1, device="cpu")
        state = strat.init(0)
        state = _state_to(state, dev)
        strat = make_strategy(name, cfg, fl, 1, device=dev)
        state, met = strat.round(state, {"tokens": tokens.to(dev)}, (0, 0))
        out[str(dev)] = (strat.params_for_eval(state),
                         met.get("select_mask", met.get("comm_edges")))
    (p_cpu, e_cpu), (p_dev, e_dev) = out["cpu"], out[str(cuda)]
    assert torch.equal(e_cpu, e_dev.cpu())
    from repro_torch.utils.pytree import tree_leaves

    for a, b in zip(tree_leaves(p_dev), tree_leaves(p_cpu)):
        scale = max(1.0, float(b.abs().max()))
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale


def _state_to(state, dev):
    """A strategy state (a PopulationState or a dict) with every tensor on
    `dev` but the round counter, which stays on the host."""
    from repro_torch.core.client_state import PopulationState
    from repro_torch.utils.pytree import tree_map

    if isinstance(state, PopulationState):
        moved = {f: tree_map(lambda t: t.to(dev), getattr(state, f))
                 for f in ("extractor", "header", "opt_e", "opt_h",
                           "loss_matrix", "last_selected")}
        return state._replace(**moved)
    return {k: (v if k == "round" else tree_map(lambda t: t.to(dev), v))
            for k, v in state.items()}


@pytest.mark.cuda
def test_serve_demo_on_card_equals_cpu_and_runs_flash(cuda):
    """The serve_demo twin's `serve_arch` for reduced qwen2-1.5b (f32,
    the demo's batch, prompt and length) from the same CPU-drawn weights
    and prompts: greedy tokens on the card equal the CPU's, and the card
    run launched flash_attention once a layer."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.examples import serve_demo

    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              dtype="float32")
    params, prompts = serve_demo.make_inputs(cfg, 4, 16, 0)
    before = ops.launch_counts()["flash_attention"]
    card, _ = serve_demo.serve_arch(cfg, params, prompts, 8, cuda)
    assert ops.launch_counts()["flash_attention"] - before == \
        cfg.num_layers
    cpu, _ = serve_demo.serve_arch(cfg, params, prompts, 8, "cpu")
    assert torch.equal(card, cpu)
