"""Port kernels against the reference's Pallas kernels (interpret mode)
and oracles: raw_gram / cosine_gram and the fused select_topk.

On the CPU the port's wrappers take their plain versions; the CUDA
kernels themselves are held to the plain versions on a card by
tests/test_torch_cuda.py and by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import peer_score as ref_ps
from repro.kernels import ref as jref
from repro.kernels import select_score as ref_ss
from repro_torch.kernels import ops, ref
from repro_torch.kernels import peer_score, select_score

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
    assert ops.launch_counts() == {"raw_gram": 0, "select_topk": 0}


@pytest.mark.parametrize("k", [0, 6, 7])
def test_select_topk_rejects_k_outside_one_to_m_minus_one(k):
    """k must pick between 1 and M-1 peers (M=6 here), on either route."""
    with pytest.raises(ValueError, match="k must be in"):
        ops.select_topk(*_torch_args(*_inputs(6, 8)), k=k, alpha=ALPHA,
                        lam=LAM)
