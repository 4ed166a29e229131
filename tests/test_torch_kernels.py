"""Port kernels against the reference's Pallas kernels (interpret mode)
and oracles: raw_gram / cosine_gram, the fused select_topk, gossip_mix
and mask_evolve.

On the CPU the port's wrappers take their plain versions; the CUDA
kernels themselves are held to the plain versions on a card by
tests/test_torch_cuda.py and by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregation import selection_to_weights as ref_weights
from repro.core.selection import select_peers as ref_select_peers
from repro.kernels import gossip_mix as ref_gm
from repro.kernels import mask_evolve as ref_me
from repro.kernels import peer_score as ref_ps
from repro.kernels import ref as jref
from repro.kernels import select_score as ref_ss
from repro_torch.kernels import ops, ref
from repro_torch.kernels import gossip_mix, mask_evolve, peer_score, \
    select_score

from test_torch_support import to_torch

ALPHA, LAM = 1.0, 0.5


def _inputs(m, p, seed=0, *, matrix_cost=False, cand=False, t=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, p)).astype(np.float32)
    last = rng.integers(-1, t, size=(m, m)).astype(np.int32)
    s_l = rng.uniform(0.0, 3.0, size=(m, m)).astype(np.float32)
    cost = (rng.uniform(0.5, 1.5, size=(m, m)).astype(np.float32)
            if matrix_cost else np.float32(1.0))
    mask = None
    if cand:
        mask = rng.uniform(size=(m, m)) < 0.7
    return x, last, s_l, t, cost, mask


def _torch_args(x, last, s_l, t, cost, mask):
    c = to_torch(cost) if np.ndim(cost) == 2 else float(cost)
    return (to_torch(x), to_torch(last), to_torch(s_l), torch.tensor(t), c,
            None if mask is None else to_torch(mask))


def _jax_args(x, last, s_l, t, cost, mask):
    return (jnp.asarray(x), jnp.asarray(last), jnp.asarray(s_l),
            jnp.int32(t), jnp.asarray(cost),
            None if mask is None else jnp.asarray(mask))


# ---------------------------------------------------------------------------
# raw_gram / cosine_gram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,p", [(5, 9), (37, 130), (128, 70)])
def test_raw_gram_plain_matches_pallas_interpret(m, p):
    """rtol 1e-5: both accumulate the same f32 products, in another order."""
    x, *_ = _inputs(m, p)
    want = np.asarray(ref_ps.raw_gram(jnp.asarray(x), interpret=True))
    got = ops.raw_gram(to_torch(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,p", [(5, 9), (37, 130)])
def test_cosine_gram_plain_matches_reference(m, p):
    """rtol 1e-5 against the Pallas path and the dense oracle."""
    x, *_ = _inputs(m, p, seed=1)
    got = ops.cosine_gram(to_torch(x)).numpy()
    kern = np.asarray(ref_ps.cosine_gram(jnp.asarray(x), interpret=True))
    oracle = np.asarray(jref.cosine_gram_ref(jnp.asarray(x)))
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ref.cosine_gram_ref(to_torch(x)).numpy(),
                               oracle, rtol=1e-5, atol=1e-6)


def test_gram_to_cosine_guards_zero_rows():
    """A zero header gives finite cosines (the 1e-12 guard), like jnp."""
    x = np.zeros((3, 4), np.float32)
    x[1] = [1, 2, 3, 4]
    got = peer_score.gram_to_cosine(ops.raw_gram(to_torch(x))).numpy()
    want = np.asarray(ref_ps.gram_to_cosine(jnp.asarray(x @ x.T)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isfinite(got).all()


# ---------------------------------------------------------------------------
# select_topk
# ---------------------------------------------------------------------------

CASES = [(m, k) for m in (5, 37, 128) for k in (1, 4, 10) if k <= m - 1]


@pytest.mark.parametrize("m,k", CASES)
@pytest.mark.parametrize("matrix_cost,cand", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_select_topk_plain_matches_reference(m, k, matrix_cost, cand):
    """Indices exact; values and stats rtol 1e-5 (f32 sums in another
    order). Against the dense oracle always, and against the Pallas
    kernel in interpret mode (M = 37 is the ragged case)."""
    args = _inputs(m, 24, seed=m + k, matrix_cost=matrix_cost, cand=cand)
    v, i, s = ops.select_topk(*_torch_args(*args), k=k, alpha=ALPHA, lam=LAM)
    refs = [jref.select_topk_ref(*_jax_args(*args), k=k, alpha=ALPHA,
                                 lam=LAM)]
    if m in (5, 37) or (k == 4 and not matrix_cost):
        refs.append(ref_ss.select_topk(*_jax_args(*args), k=k, alpha=ALPHA,
                                       lam=LAM, interpret=True))
    for rv, ri, rs in refs:
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5,
                                   atol=1e-5)
    assert i.dtype == torch.int32 and v.shape == (m, k) and s.shape == (m, 2)


def test_select_topk_ties_go_to_lowest_column():
    """Exact indices on exactly tied scores: identical headers, s_l and
    recency make every off-diagonal score equal, so the lowest columns
    win — as jax.lax.top_k and the Pallas kernel break ties."""
    m, k = 9, 4
    x = np.tile(np.arange(1, 7, dtype=np.float32), (m, 1))
    last = np.full((m, m), -1, np.int32)
    s_l = np.ones((m, m), np.float32)
    args = (x, last, s_l, 2, np.float32(0.5), None)
    v, i, _ = ops.select_topk(*_torch_args(*args), k=k, alpha=ALPHA, lam=LAM)
    rv, ri, _ = ref_ss.select_topk(*_jax_args(*args), k=k, alpha=ALPHA,
                                   lam=LAM, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    want = np.array([[j for j in range(m) if j != r][:k] for r in range(m)])
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


def test_select_topk_partial_ties_keep_order():
    """Exact: tied groups among distinct scores still order by column."""
    m, k = 8, 5
    rng = np.random.default_rng(7)
    x = np.tile(rng.normal(size=(1, 5)).astype(np.float32), (m, 1))
    s_l = np.repeat(rng.integers(0, 3, size=(1, m)), m, 0).astype(np.float32)
    last = np.full((m, m), -1, np.int32)
    args = (x, last, s_l, 1, np.float32(1.0), None)
    _, i, _ = ops.select_topk(*_torch_args(*args), k=k, alpha=ALPHA, lam=LAM)
    _, ri, _ = jref.select_topk_ref(*_jax_args(*args), k=k, alpha=ALPHA,
                                    lam=LAM)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def test_select_topk_rejects_bad_k():
    args = _torch_args(*_inputs(5, 8))
    with pytest.raises(ValueError):
        ops.select_topk(*args, k=5, alpha=ALPHA, lam=LAM)
    with pytest.raises(ValueError):
        ops.select_topk(*args, k=0, alpha=ALPHA, lam=LAM)


# ---------------------------------------------------------------------------
# routing: a CUDA tensor reaches the kernel or raises; no fallback
# ---------------------------------------------------------------------------

def test_impl_cuda_on_cpu_tensor_raises():
    x = torch.ones(4, 3)
    with pytest.raises(ValueError):
        ops.raw_gram(x, impl="cuda")
    with pytest.raises(ValueError):
        ops.select_topk(*_torch_args(*_inputs(5, 8)), k=2, alpha=ALPHA,
                        lam=LAM, impl="cuda")
    with pytest.raises(ValueError):
        ops.raw_gram(x, impl="triton")


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers check their inputs before any build or launch."""
    with pytest.raises(ValueError):
        peer_score.raw_gram_cuda(torch.ones(4, 3))
    with pytest.raises(ValueError):
        select_score.select_topk_cuda(*_torch_args(*_inputs(5, 8)), k=2,
                                      alpha=ALPHA, lam=LAM)


def test_plain_route_counts_no_launches():
    ops.reset_launch_counts()
    ops.select_topk(*_torch_args(*_inputs(6, 8)), k=2, alpha=ALPHA, lam=LAM)
    ops.cosine_gram(torch.ones(4, 3))
    ops.gossip_mix(torch.ones(4, 3), torch.zeros(4, 2, dtype=torch.int32),
                   torch.ones(4, 2))
    ops.mask_evolve(torch.ones(4, 3), torch.zeros(4, 3, dtype=torch.bool),
                    keep=5)
    ops.flash_attention(torch.ones(1, 3, 2, 8), torch.ones(1, 3, 1, 8),
                        torch.ones(1, 3, 1, 8))
    ops.wkv(*(torch.ones(1, 3, 2, 8) for _ in range(4)), torch.ones(2, 8))
    assert ops.launch_counts() == {"flash_attention": 0, "gossip_mix": 0,
                                   "mask_evolve": 0, "raw_gram": 0,
                                   "select_topk": 0, "wkv_chunked": 0}


@pytest.mark.parametrize("k", [0, 6, 7])
def test_select_topk_rejects_k_outside_one_to_m_minus_one(k):
    """k must pick between 1 and M-1 peers (M=6 here), on either route."""
    with pytest.raises(ValueError, match="k must be in"):
        ops.select_topk(*_torch_args(*_inputs(6, 8)), k=k, alpha=ALPHA,
                        lam=LAM)


# ---------------------------------------------------------------------------
# gossip_mix
# ---------------------------------------------------------------------------

def _gossip_inputs(m, f, k, directed, seed=0):
    """A plan-shaped instance made by the reference: a random k-peer
    selection (symmetrized when undirected), random inactive rows,
    row-stochastic weights with self, packed lists. → numpy (x, idx, w,
    dense weights)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    mask = ref_select_peers(jax.random.uniform(ks[0], (m, m)), k=k,
                            candidate_mask=~jnp.eye(m, dtype=bool))
    if not directed:
        mask = mask | mask.T
    mask = mask & jax.random.bernoulli(ks[1], 0.7, (m,))[:, None]
    w = ref_weights(mask, include_self=True)
    x = jax.random.normal(ks[2], (m, f), jnp.float32)
    d = ref_gm.gossip_degree_bound(k, m, directed=directed)
    idx, wl = ref_gm.weights_to_neighbors(w, d)
    return tuple(np.asarray(a) for a in (x, idx, wl, w))


GOSSIP_CASES = [(8, 16, 2, True), (17, 130, 3, False), (33, 257, 5, False),
                (64, 384, 10, True)]


@pytest.mark.parametrize("m,f,k,directed", GOSSIP_CASES)
def test_gossip_mix_plain_bitwise_equals_reference(m, f, k, directed):
    """Bitwise against the Pallas kernel (interpret), gossip_mix_blocked
    and ref.gossip_mix_ref: every route accumulates the ascending slots
    with one single-rounded multiply-add each (XLA's CPU FMA). Undirected
    plans carry D = M slots, most of them zero-weight padding."""
    x, idx, wl, _ = _gossip_inputs(m, f, k, directed, seed=m)
    args = (jnp.asarray(x), jnp.asarray(idx), jnp.asarray(wl))
    got = gossip_mix.gossip_mix_plain(*(to_torch(a) for a in (x, idx, wl)))
    routed = ops.gossip_mix(*(to_torch(a) for a in (x, idx, wl)))
    oracle = ref.gossip_mix_ref(*(to_torch(a) for a in (x, idx, wl)))
    for want in (ref_gm.gossip_mix(*args, block_f=128, interpret=True),
                 ref_gm.gossip_mix_blocked(*args), jref.gossip_mix_ref(*args)):
        want = np.asarray(want)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
        np.testing.assert_array_equal(routed.numpy().view(np.int32),
                                      want.view(np.int32))
        np.testing.assert_array_equal(oracle.numpy().view(np.int32),
                                      want.view(np.int32))


def test_gossip_mix_plain_is_not_mul_then_add():
    """The FMA matters: a mul-then-add loop differs from the reference in
    the last bit somewhere, the plain version nowhere."""
    x, idx, wl, _ = _gossip_inputs(16, 3000, 4, True)
    want = np.asarray(ref_gm.gossip_mix_blocked(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(wl)))
    xt, it, wt = to_torch(x), to_torch(idx).long(), to_torch(wl)
    acc = torch.zeros_like(xt)
    for d in range(it.shape[1]):
        acc = acc + wt[:, d:d + 1] * xt[it[:, d]]
    assert (acc.numpy() != want).any()
    got = gossip_mix.gossip_mix_plain(xt, to_torch(idx), wt).numpy()
    np.testing.assert_array_equal(got, want)


def test_fma_f32_rounds_once():
    """fma_f32(a, b, c) is the float32 value nearest the exact a·b + c
    (checked against exact rationals), including cancellations."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.normal(size=3000).astype(np.float32)
    b = rng.normal(size=3000).astype(np.float32)
    c = (rng.normal(size=3000) * rng.choice([1e-8, 1.0, 1e8], 3000)).astype(
        np.float32)
    c[:500] = -(a[:500].astype(np.float64) * b[:500]).astype(np.float32)
    got = ref.fma_f32(to_torch(a), to_torch(b), to_torch(c)).numpy()
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        err = abs(Fraction(float(got[i])) - exact)
        for nb in (np.nextafter(got[i], np.float32(-np.inf)),
                   np.nextafter(got[i], np.float32(np.inf))):
            assert err <= abs(Fraction(float(nb)) - exact), i


@pytest.mark.parametrize("m,k,directed", [(9, 2, True), (17, 3, False),
                                          (33, 5, True)])
def test_weights_to_neighbors_matches_reference(m, k, directed):
    """Exact: the same ascending (idx, w) lists and zero padding."""
    _, idx, wl, w = _gossip_inputs(m, 4, k, directed, seed=k)
    d = gossip_mix.gossip_degree_bound(k, m, directed=directed)
    assert d == ref_gm.gossip_degree_bound(k, m, directed=directed)
    got_idx, got_w = gossip_mix.weights_to_neighbors(to_torch(w), d)
    assert got_idx.dtype == torch.int32 and got_w.dtype == torch.float32
    np.testing.assert_array_equal(got_idx.numpy(), idx)
    np.testing.assert_array_equal(got_w.numpy(), wl)


def test_gossip_mix_dense_matches_reference():
    """rtol 1e-6: one f32 matrix product against the reference's einsum
    (the same products, summed in another order)."""
    x, idx, wl, _ = _gossip_inputs(17, 130, 3, False)
    got = gossip_mix.gossip_mix_dense(*(to_torch(a) for a in (x, idx, wl)))
    want = ref_gm.gossip_mix_dense(jnp.asarray(x), jnp.asarray(idx),
                                   jnp.asarray(wl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_packs_gossip_plans_by_device():
    """CUDA always packs (the TPU branch of the reference); the CPU keeps
    the reference's CPU threshold, so the CPU tests compare like routes."""
    assert ops.packs_gossip_plans(16, "cuda")
    assert not ops.packs_gossip_plans(16, "cpu")
    assert not ops.packs_gossip_plans(1023, "cpu")
    assert ops.packs_gossip_plans(1024, "cpu")


# ---------------------------------------------------------------------------
# mask_evolve
# ---------------------------------------------------------------------------

def _evolve_inputs(shape, dtype, *, ties=False, seed=0):
    """(x, grow) made in the reference's types: numpy float32 values cast
    by jnp to `dtype`; grow = uniform > 0.98 (the dispfl regrow rate)."""
    rng = np.random.default_rng(seed)
    if ties:
        x = rng.integers(-4, 5, size=shape).astype(np.float32) * 0.25
    else:
        x = rng.normal(size=shape).astype(np.float32)
    grow = rng.uniform(size=shape) > 0.98
    return jnp.asarray(x).astype(dtype), jnp.asarray(grow)


def _to_port(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return to_torch(a)


def _bits(a):
    """Integer view of a float array (numpy or torch), signed zeros kept."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32)
        return a.numpy()
    return a.view(np.int16 if a.dtype == jnp.bfloat16 else np.int32)


EVOLVE_CASES = [
    ((6, 37), jnp.float32, False, "half"),       # below 2048 elements
    ((4, 3, 3, 8, 8), jnp.float32, False, "half"),
    ((4, 3, 3, 8, 8), jnp.bfloat16, False, "half"),
    ((5, 700), jnp.float32, True, "half"),       # ties at the threshold
    ((5, 700), jnp.bfloat16, True, "half"),
    ((3, 50), jnp.float32, False, "one"),
    ((3, 50), jnp.bfloat16, True, "all"),
    ((3, 50), jnp.float32, True, "all"),
]


def _assert_same_zeros_up_to_sign(got, want):
    """Bits equal wherever `want` is nonzero; zeros (of either sign) where
    it is zero."""
    got, want = _bits(got), _bits(want)
    zero_bits = 0x7FFF if got.dtype == np.int16 else 0x7FFFFFFF
    nz = (want & zero_bits) != 0
    np.testing.assert_array_equal(got[nz], want[nz])
    assert not (got[~nz] & zero_bits).any()


@pytest.mark.parametrize("shape,dtype,ties,keep_kind", EVOLVE_CASES)
def test_mask_evolve_plain_bitwise_equals_reference(shape, dtype, ties,
                                                    keep_kind):
    """Bitwise: the threshold against the reference's bisection and
    partition, and the mask and output bits (signed zeros count) against
    the reference's oracle `mask_evolve_ref`, run as written (a product:
    a dropped negative weight becomes −0.0); the port's own oracle
    (torch.kthvalue) and routed version too. Against the Pallas kernel
    (interpret), the mask bitwise and the output bitwise up to the sign of
    dropped entries: XLA rewrites its x·convert(mask) into a select, so
    its dropped negatives are +0.0 (ROADMAP queue 3)."""
    x, grow = _evolve_inputs(shape, dtype, ties=ties, seed=len(shape))
    n = x.size
    keep = {"half": max(int(n * 0.5), 1), "one": 1, "all": n}[keep_kind]
    tx, tg = _to_port(x), _to_port(grow)
    out, mask, thr = mask_evolve.mask_evolve_plain(tx, tg, keep=keep)
    flat = jnp.abs(x.astype(jnp.float32)).ravel()
    for want_thr in (ref_me.magnitude_threshold(flat, n - keep),
                     jnp.partition(flat, n - keep)[n - keep]):
        np.testing.assert_array_equal(thr.numpy().view(np.int32),
                                      np.asarray(want_thr).view(np.int32))
    routed = ops.mask_evolve(tx, tg, keep=keep)
    oracle = ref.mask_evolve_ref(tx, tg, keep=keep)
    want_out, want_mask = (np.asarray(a) for a in
                           jref.mask_evolve_ref(x, grow, keep=keep))
    for got_out, got_mask in ((out, mask), routed, oracle):
        assert got_out.dtype == tx.dtype and got_mask.dtype == torch.bool
        np.testing.assert_array_equal(got_mask.numpy(), want_mask)
        np.testing.assert_array_equal(_bits(got_out), _bits(want_out))
    kern_out, kern_mask = ref_me.mask_evolve(x, grow, keep=keep,
                                             interpret=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(kern_mask))
    _assert_same_zeros_up_to_sign(out, np.asarray(kern_out))


def test_mask_evolve_keeps_exactly_keep_without_ties_or_regrow():
    """Distinct magnitudes, no regrow: exactly `keep` entries survive, the
    largest ones."""
    x = torch.randperm(500).float().reshape(5, 100) - 250.0
    none = torch.zeros(x.shape, dtype=torch.bool)
    out, mask, thr = mask_evolve.mask_evolve_plain(x, none, keep=123)
    assert int(mask.sum()) == 123
    assert float(thr) == float(x.abs().flatten().sort().values[500 - 123])
    assert torch.equal(out, torch.where(mask, x, x * 0))


@pytest.mark.parametrize("keep", [0, 11])
def test_mask_evolve_rejects_keep_outside_one_to_n(keep):
    with pytest.raises(ValueError, match="keep must be in"):
        ops.mask_evolve(torch.ones(2, 5), torch.zeros(2, 5, dtype=torch.bool),
                        keep=keep)


def test_new_cuda_wrappers_refuse_cpu_tensors():
    """Both new kernel wrappers check their inputs before any build or
    launch, and impl='cuda' on a CPU tensor raises."""
    x = torch.ones(4, 3)
    idx = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        gossip_mix.gossip_mix_cuda(x, idx, torch.ones(4, 2))
    with pytest.raises(ValueError):
        ops.gossip_mix(x, idx, torch.ones(4, 2), impl="cuda")
    grow = torch.zeros(4, 3, dtype=torch.bool)
    with pytest.raises(ValueError):
        mask_evolve.mask_evolve_cuda(x, grow, keep=3)
    with pytest.raises(ValueError):
        ops.mask_evolve(x, grow, keep=3, impl="cuda")
