"""The port's comms fabric (`repro_torch.comms`) against the reference's
`repro.comms`, module by module, on the CPU.

Topologies (dense and CSR), degree bounds, link models, the Eq. 9 cost
matrices (dense and per slot) and the transport's `TrafficStats` are numpy
in both packages and must be bitwise equal, for every topology at
M ∈ {8, 16, 33} and two seeds. The network events draw from torch
generators (the reference's threefry draws cannot be reproduced), so they
are held to their structure (symmetric drops, the stale-column-only rule,
p = 0 draws nothing) and their rates (within 4σ of p over 10⁴ draws).
The packed scorer `score_topk_sparse` must match the reference's and the
dense oracle `select_score_nbr_ref`: indices exact, values rtol 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms import fabric as ref_fabric
from repro.comms import linkcost as ref_link
from repro.comms import topology as ref_topo
from repro.comms import transport as ref_transport
from repro.configs.base import CommsConfig as RefCommsConfig
from repro.core.scoring import score_topk_sparse as ref_score_topk_sparse
from repro.kernels.gossip_mix import gossip_degree_bound as ref_degree_bound
from repro.kernels.ref import select_score_nbr_ref as ref_nbr_ref
from repro.utils.pytree import tree_bytes as ref_tree_bytes
from repro.utils.pytree import tree_size as ref_tree_size
from repro_torch import comms
from repro_torch.comms import events, linkcost, topology, transport
from repro_torch.configs import CommsConfig
from repro_torch.core.scoring import score_topk_sparse
from repro_torch.core.selection import NEG, topk_to_mask
from repro_torch.fl.engine import named_streams
from repro_torch.kernels.gossip_mix import gossip_degree_bound
from repro_torch.kernels.ref import select_score_nbr_ref
from repro_torch.utils.pytree import tree_bytes, tree_size

SIZES = [8, 16, 33]
SEEDS = [0, 1]
LINKS = ["uniform", "hetero", "geometric"]


def _cfgs(topo="full", seed=0, **kw):
    """The same CommsConfig in both packages."""
    kw = dict(topology=topo, graph_seed=seed, hier_cluster=4, geo_cells=3,
              ring_hops=1 + seed, **kw)
    return CommsConfig(**kw), RefCommsConfig(**kw)


def _assert_stats_equal(got, want):
    np.testing.assert_array_equal(got.bytes_sent, want.bytes_sent)
    np.testing.assert_array_equal(got.bytes_recv, want.bytes_recv)
    assert got.bytes_sent.dtype == want.bytes_sent.dtype
    assert (got.messages, got.wire_bytes, got.total_bytes) == \
        (want.messages, want.wire_bytes, want.total_bytes)
    assert got.sim_time_s == want.sim_time_s
    assert got.energy_j == want.energy_j


# ---------------------------------------------------------------------------
# numpy modules: bitwise against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("topo", topology.TOPOLOGIES)
def test_topology_matches_reference(topo, m, seed):
    """CSR, dense adjacency and degree bound equal the reference's, and the
    fabric's static adjacency is the dense view (None when dynamic)."""
    cfg, rcfg = _cfgs(topo, seed)
    got = topology.make_sparse_topology(topo, m, cfg=cfg, seed=seed)
    want = ref_topo.make_sparse_topology(topo, m, cfg=rcfg, seed=seed)
    assert topology.topology_degree_bound(cfg, m) == \
        ref_topo.topology_degree_bound(rcfg, m)
    fab = comms.make_fabric(cfg, m, device="cpu")
    if want is None:
        assert got is None and fab.is_dynamic and fab.static_adj is None
        return
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.indptr.dtype == want.indptr.dtype
    assert got.indices.dtype == want.indices.dtype
    dense = topology.make_topology(topo, m, cfg=cfg, seed=seed)
    np.testing.assert_array_equal(
        dense, ref_topo.make_topology(topo, m, cfg=rcfg, seed=seed))
    np.testing.assert_array_equal(fab.static_adj.numpy(), dense)
    assert got.is_symmetric() and got.max_degree == \
        topology.topology_degree_bound(cfg, m)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("m", SIZES)
def test_dense_generators_match_reference(m, seed):
    """The dense oracles the CSR builds are held to, bitwise."""
    for name, args in (("fully_connected", ()), ("ring", (1 + seed,)),
                       ("torus", ())):
        np.testing.assert_array_equal(getattr(topology, name)(m, *args),
                                      getattr(ref_topo, name)(m, *args))
    np.testing.assert_array_equal(
        topology.erdos_renyi(m, 0.3, np.random.default_rng(seed)),
        ref_topo.erdos_renyi(m, 0.3, np.random.default_rng(seed)))
    np.testing.assert_array_equal(
        topology.small_world(m, 4, 0.3, np.random.default_rng(seed)),
        ref_topo.small_world(m, 4, 0.3, np.random.default_rng(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("link", LINKS)
def test_links_and_costs_match_reference(link, m, seed):
    """Dense link matrices, `cost_scores`, the per-edge links, their
    global t_min and `edge_cost_scores`, and the fabrics' cost views
    (dense matrix, per-slot, scattered dense oracle) equal the
    reference's bitwise."""
    cfg, rcfg = _cfgs("full", seed, link_model=link, hetero_spread=3.0)
    got, want = linkcost.make_link_model(cfg, m), \
        ref_link.make_link_model(rcfg, m)
    for f in ("bandwidth", "latency_s", "energy_j_per_byte"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(linkcost.cost_scores(got, 0.7),
                                  ref_link.cost_scores(want, 0.7))
    rates = np.linspace(0.5, 1.0, m)
    scaled = linkcost.scale_by_channel_rate(got, rates)
    np.testing.assert_array_equal(
        scaled.bandwidth,
        ref_link.scale_by_channel_rate(want, rates).bandwidth)
    for topo in ("ring", "hier_ring", "geo_cell", "torus"):
        cfg, rcfg = _cfgs(topo, seed, link_model=link, hetero_spread=3.0)
        t = topology.make_sparse_topology(topo, m, cfg=cfg, seed=seed)
        ge = linkcost.make_edge_link_model(cfg, t)
        we = ref_link.make_edge_link_model(rcfg, t)
        for f in ("bandwidth", "latency_s", "energy_j_per_byte"):
            np.testing.assert_array_equal(getattr(ge, f), getattr(we, f))
        assert ge.t_min_ref == we.t_min_ref
        np.testing.assert_array_equal(linkcost.edge_cost_scores(ge, 0.7),
                                      ref_link.edge_cost_scores(we, 0.7))
        dense = comms.make_fabric(cfg, m, cost_scale=0.7, device="cpu")
        np.testing.assert_array_equal(
            dense.cost.numpy(),
            np.asarray(ref_fabric.make_fabric(rcfg, m, cost_scale=0.7).cost))
        cfg_s = dataclasses.replace(cfg, sparse=True)
        rcfg_s = dataclasses.replace(rcfg, sparse=True)
        fs = comms.make_fabric(cfg_s, m, cost_scale=0.7, device="cpu")
        rs = ref_fabric.make_fabric(rcfg_s, m, cost_scale=0.7)
        for f in ("nbr_idx", "nbr_static", "slot_cost", "edge_cost", "cost"):
            np.testing.assert_array_equal(getattr(fs, f).numpy(),
                                          np.asarray(getattr(rs, f)),
                                          err_msg=f)
        assert fs.degree_bound == rs.degree_bound
        # the packed costs sit at the dense matrix's edge entries
        rows, cols = t.edge_endpoints()
        np.testing.assert_array_equal(fs.cost.numpy()[rows, cols],
                                      dense.cost.numpy()[rows, cols])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("link", LINKS)
def test_transport_matches_reference(link, m, seed):
    """`TrafficStats` of star, dense p2p and per-edge exchanges, and the
    fabrics' `account_round`, equal the reference's bitwise."""
    rng = np.random.default_rng(seed + 10 * m)
    cfg, rcfg = _cfgs("hier_ring", seed, link_model=link)
    lm, rlm = linkcost.make_link_model(cfg, m), ref_link.make_link_model(
        rcfg, m)
    active = rng.random(m) < 0.5
    _assert_stats_equal(
        transport.star_exchange(lm, active, up_bytes=1000, down_bytes=777),
        ref_transport.star_exchange(rlm, active, up_bytes=1000,
                                    down_bytes=777))
    edges = rng.random((m, m)) < 0.3
    np.fill_diagonal(edges, False)
    _assert_stats_equal(transport.simulate_exchange(lm, edges, 4096),
                        ref_transport.simulate_exchange(rlm, edges, 4096))
    t = topology.make_sparse_topology("hier_ring", m, cfg=cfg, seed=seed)
    ge = linkcost.make_edge_link_model(cfg, t)
    we = ref_link.make_edge_link_model(rcfg, t)
    act = rng.random(t.num_edges) < 0.6
    _assert_stats_equal(transport.simulate_exchange_edges(ge, act, 4096),
                        ref_transport.simulate_exchange_edges(we, act, 4096))
    # the fabrics' round accounting from a round's metrics
    fab = comms.make_fabric(cfg, m, device="cpu")
    rfab = ref_fabric.make_fabric(rcfg, m)
    met = {"active": torch.from_numpy(active),
           "comm_edges": torch.from_numpy(edges)}
    rmet = {"active": active, "comm_edges": edges}
    for pattern in ("star", "p2p"):
        _assert_stats_equal(fab.account_round(pattern, met, 512),
                            rfab.account_round(pattern, rmet, 512))
    cut = edges & fab.static_adj.numpy()
    fs = comms.make_fabric(dataclasses.replace(cfg, sparse=True), m,
                           device="cpu")
    rs = ref_fabric.make_fabric(dataclasses.replace(rcfg, sparse=True), m)
    _assert_stats_equal(
        fs.account_round("p2p", {"select_mask": torch.from_numpy(cut)}, 512),
        rs.account_round("p2p", {"select_mask": cut}, 512))


def test_fabric_refusals_match_reference():
    """The packed fabric refuses star accounting, off-graph edges, a
    dynamic topology and channel rates; the dense views refuse past
    DENSE_ORACLE_MAX; a round without edges cannot be priced."""
    cfg, _ = _cfgs("ring", sparse=True)
    fs = comms.make_fabric(cfg, 8, device="cpu")
    with pytest.raises(ValueError, match="p2p gossip only"):
        fs.account_round("star", {"active": torch.ones(8, dtype=bool)}, 8)
    with pytest.raises(ValueError, match="outside the sparse topology"):
        fs.account(torch.ones(8, 8, dtype=bool), 8)
    with pytest.raises(KeyError, match="comm_edges"):
        fs.account_round("p2p", {}, 8)
    with pytest.raises(ValueError, match="static topology"):
        CommsConfig(topology="dynamic", sparse=True)
    with pytest.raises(ValueError, match="stale_mode"):
        CommsConfig(stale_mode="late")
    with pytest.raises(NotImplementedError, match="channel_rate"):
        comms.SparseFabric(cfg, 8, channel_rate=np.ones(8), device="cpu")
    big = comms.make_fabric(dataclasses.replace(cfg, topology="hier_ring"),
                            comms.DENSE_ORACLE_MAX + 1, device="cpu")
    for view in ("cost", "cand_dense"):
        with pytest.raises(RuntimeError, match="DENSE_ORACLE_MAX"):
            v = getattr(big, view)
            v(big.nbr_static) if callable(v) else v
    assert comms.make_fabric(None, 8, device="cpu") is None


@pytest.mark.parametrize("bits,overhead", [(0, 0), (0, 64), (8, 0), (3, 16)])
def test_payload_and_tree_bytes_match_reference(bits, overhead):
    """`payload_bytes_per_client`, `tree_size` and `tree_bytes` over the
    port's stacked torch trees equal the reference's over the same
    arrays, f32 and bf16 leaves alike."""
    rng = np.random.default_rng(0)
    m = 6
    arrays = {"a.w": rng.normal(size=(m, 3, 5)).astype(np.float32),
              "b": rng.normal(size=(m, 7)).astype(np.float32)}
    tree = {"a.w": torch.from_numpy(arrays["a.w"]),
            "b": torch.from_numpy(arrays["b"]).to(torch.bfloat16)}
    rtree = {"a.w": jnp.asarray(arrays["a.w"]),
             "b": jnp.asarray(arrays["b"], jnp.bfloat16)}
    assert tree_size(tree) == ref_tree_size(rtree)
    assert tree_bytes(tree) == ref_tree_bytes(rtree)
    assert transport.payload_bytes_per_client(
        tree, m, bits=bits, overhead_bytes=overhead) == \
        ref_transport.payload_bytes_per_client(
            rtree, m, bits=bits, overhead_bytes=overhead)


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("topo_degree", [None, 2, 4, 40])
def test_gossip_degree_bound_matches_reference(directed, topo_degree):
    for k, m in ((2, 6), (4, 16), (12, 16), (4, 1024)):
        assert gossip_degree_bound(k, m, directed=directed,
                                   topo_degree=topo_degree) == \
            ref_degree_bound(k, m, directed=directed,
                             topo_degree=topo_degree)


# ---------------------------------------------------------------------------
# events: structure and rates (other bits than the reference's threefry)
# ---------------------------------------------------------------------------

def _streams(seed):
    return named_streams((seed, 0), comms.NET_STREAMS)


def test_events_at_zero_probability_draw_nothing():
    """The default config's events are the identity and leave every
    generator where it was."""
    cfg, _ = _cfgs("ring")
    for fab in (comms.make_fabric(cfg, 16, device="cpu"),
                comms.make_fabric(dataclasses.replace(cfg, sparse=True), 16,
                                  device="cpu")):
        streams = _streams(0)
        before = {k: g.get_state() for k, g in streams.items()}
        cand, avail, stale = fab.round_masks(streams)
        np.testing.assert_array_equal(cand.numpy(),
                                      topology.ring(16, cfg.ring_hops))
        assert avail.all() and not stale.any() and stale.dtype == torch.int32
        for k, g in streams.items():
            assert torch.equal(g.get_state(), before[k]), k


@pytest.mark.parametrize("seed", SEEDS)
def test_dropout_is_symmetric_and_pair_keyed(seed):
    """Both directions of an edge drop together, on the dense grid and on
    the CSR edge list; the pair-keyed draws equal their dense oracle's at
    every edge, and are the identity at p = 0."""
    m = 33
    adj = torch.from_numpy(topology.fully_connected(m))
    cand = events.drop_links(_streams(seed)["drop"], adj, 0.4)
    assert torch.equal(cand, cand.T) and not cand.diagonal().any()
    assert (~cand & adj).any()
    t = topology.make_sparse_topology("torus", m)
    rows, cols = (torch.from_numpy(a) for a in t.edge_endpoints())
    keep = events.drop_edges(_streams(seed)["drop"], rows, cols, 0.4)
    dense = torch.zeros(m, m, dtype=torch.bool)
    dense[rows.long(), cols.long()] = keep
    assert torch.equal(dense, dense.T)
    oracle = events.drop_links_pairfold(_streams(seed)["drop"],
                                        torch.from_numpy(t.dense()), 0.4)
    assert torch.equal(oracle, dense)
    assert events.drop_edges(None, rows, cols, 0.0).all()
    assert torch.equal(events.drop_links(None, adj, 0.0), adj)
    u = events.edge_pair_uniform(123, rows, cols)
    assert torch.equal(u, events.edge_pair_uniform(123, cols, rows))
    assert u.dtype == torch.float32 and (u >= 0).all() and (u < 1).all()


def test_stale_peers_lose_their_column_only():
    """Under stale_mode="drop" a stale peer can still pull (its row is
    kept) but nobody pulls from it; under "serve" it stays selectable.
    The dense and the packed fabric draw the same (M,) events."""
    m = 16
    cfg, _ = _cfgs("full", p_stale=0.3, max_staleness=3)
    fab = comms.make_fabric(cfg, m, device="cpu")
    cand, avail, stale = fab.round_masks(_streams(3))
    fresh = stale == 0
    assert (~fresh).any() and avail.all()
    full = torch.from_numpy(topology.fully_connected(m))
    assert torch.equal(cand, full & fresh[None, :])
    assert int(stale.max()) <= 3 and int(stale[~fresh].min()) >= 1
    serve = comms.make_fabric(dataclasses.replace(cfg, stale_mode="serve"),
                              m, device="cpu")
    cand_s, _, stale_s = serve.round_masks(_streams(3))
    assert torch.equal(cand_s, full) and torch.equal(stale_s, stale)
    cfg_h, _ = _cfgs("hier_ring", p_stale=0.3, availability=0.8)
    dense = comms.make_fabric(cfg_h, m, device="cpu")
    packed = comms.make_fabric(dataclasses.replace(cfg_h, sparse=True), m,
                               device="cpu")
    cd, ad, sd = dense.round_masks(_streams(4))
    cp, ap, sp = packed.round_masks(_streams(4))
    assert torch.equal(cd, cp) and torch.equal(ad, ap) and \
        torch.equal(sd, sp)
    assert not cd[~ad].any() and not cd[:, ~ad].any()


def _within_4_sigma(hits, n, p):
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(hits / n - p) <= 4 * sigma, (hits / n, p, sigma)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_event_rates_within_4_sigma(p):
    """Over 10⁴ draws each: offline rate 1 − availability, stale rate
    p_stale with lags uniform over 1..max, edge-drop rate p_link_drop on
    the dense grid and the pair-keyed CSR path (one draw per undirected
    edge)."""
    n = 10_000
    s = _streams(7)
    avail = events.availability_mask(s["avail"], n, 1 - p)
    _within_4_sigma(int((~avail).sum()), n, p)
    stale = events.staleness_rounds(s["stale"], n, p, 4)
    _within_4_sigma(int((stale > 0).sum()), n, p)
    lags = stale[stale > 0]
    assert set(lags.tolist()) == {1, 2, 3, 4}
    _within_4_sigma(int((lags == 1).sum()), lags.numel(), 0.25)
    m = 142                       # 142·141/2 = 10,011 undirected pairs
    adj = torch.from_numpy(topology.fully_connected(m))
    kept = events.drop_links(s["drop"], adj, p)
    pairs = m * (m - 1) // 2
    _within_4_sigma(pairs - int(kept.sum()) // 2, pairs, p)
    t = topology.make_sparse_topology("full", m)
    rows, cols = (torch.from_numpy(a) for a in t.edge_endpoints())
    keep = events.drop_edges(s["drop"], rows, cols, p)
    _within_4_sigma(int((~keep).sum()) // 2, pairs, p)


def test_dynamic_topk_matches_reference_on_separated_affinities():
    """With affinities further apart than the tie noise (1e-6) and no
    exploration, the dynamic graph is the reference's; with exploration
    it is a symmetric superset without self-loops."""
    import jax

    m = 16
    aff = np.random.default_rng(0).permutation(m * m).reshape(m, m) * 1e-3
    aff = aff.astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    got = topology.dynamic_topk(torch.from_numpy(aff), 3, gen)
    want = ref_topo.dynamic_topk(jnp.asarray(aff), 3, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    explored = topology.dynamic_topk(torch.from_numpy(aff), 3, gen,
                                     explore=2)
    assert torch.equal(explored, explored.T)
    assert not explored.diagonal().any() and (explored >= got).all()
    assert (explored.sum(1) >= 3).all()


# ---------------------------------------------------------------------------
# the packed scorer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo,m,k", [("torus", 24, 3), ("hier_ring", 33, 2),
                                      ("geo_cell", 16, 5), ("ring", 8, 1)])
@pytest.mark.parametrize("form", ["dense", "gathered"])
def test_score_topk_sparse_matches_reference(topo, m, k, form):
    """Indices exact and values rtol 1e-5 against the reference's
    `score_topk_sparse`, and against the dense oracle (the port's and the
    reference's `select_score_nbr_ref`) in both input forms; the row
    statistics (sums of f32 products in another order) to rtol 1e-5."""
    cfg, rcfg = _cfgs(topo, 0, link_model="hetero", p_link_drop=0.3,
                      availability=0.8, sparse=True)
    fs = comms.make_fabric(cfg, m, device="cpu")
    slot_mask, _, _ = fs.round_slots(_streams(m))
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 40)).astype(np.float32)
    last = rng.integers(-1, 6, (m, m)).astype(np.int32)
    loss = (rng.standard_normal((m, m)) ** 2).astype(np.float32)
    idx = fs.nbr_idx.numpy()
    valid = slot_mask.numpy()
    if form == "dense":
        args_t = (torch.from_numpy(last), torch.from_numpy(loss),
                  fs.cost)
        args_r = (jnp.asarray(last), jnp.asarray(loss),
                  jnp.asarray(fs.cost.numpy()))
    else:
        g_last, g_loss = (np.take_along_axis(a, idx.astype(np.int64), 1)
                          for a in (last, loss))
        args_t = (torch.from_numpy(g_last), torch.from_numpy(g_loss),
                  fs.slot_cost)
        args_r = (jnp.asarray(g_last), jnp.asarray(g_loss),
                  jnp.asarray(fs.slot_cost.numpy()))
    kw = dict(alpha=1.0, lam=0.5, k=k)
    vals, sel, stats = score_topk_sparse(
        torch.from_numpy(x), args_t[0], args_t[1], 3,
        nbr_idx=fs.nbr_idx, nbr_valid=slot_mask, comm_cost=args_t[2], **kw)
    rv, ri, rs = ref_score_topk_sparse(
        jnp.asarray(x), args_r[0], args_r[1], 3, nbr_idx=jnp.asarray(idx),
        nbr_valid=jnp.asarray(valid), comm_cost=args_r[2], **kw)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ri))
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=1e-5)
    np.testing.assert_allclose(stats.numpy(), np.asarray(rs), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(
        topk_to_mask(sel, vals, m).numpy(),
        np.asarray(topk_to_mask_ref(ri, rv, m)))
    # the dense oracle, gathered at the packed slots, gives the same top-k
    dense_args = (torch.from_numpy(last), torch.from_numpy(loss), 3,
                  fs.cost, fs.nbr_idx, slot_mask)
    oracle = select_score_nbr_ref(torch.from_numpy(x), *dense_args,
                                  alpha=1.0, lam=0.5)
    r_oracle = ref_nbr_ref(jnp.asarray(x), jnp.asarray(last),
                           jnp.asarray(loss), 3, jnp.asarray(fs.cost.numpy()),
                           jnp.asarray(idx), jnp.asarray(valid), alpha=1.0,
                           lam=0.5)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(r_oracle),
                               rtol=1e-5)
    kk = min(k, idx.shape[1])
    top = torch.sort(oracle, dim=1, descending=True, stable=True)
    np.testing.assert_allclose(vals[:, :kk].numpy(), top.values[:, :kk],
                               rtol=1e-5)


def topk_to_mask_ref(idx, vals, m):
    from repro.core.selection import topk_to_mask as ref_topk_to_mask

    return ref_topk_to_mask(idx, vals, m)


def test_score_topk_sparse_pad_never_collides():
    """The reference's regression: padding slots carry fill id 0, and a
    floor-valued pick must name the row itself, never overwrite client
    0's genuine selection in `topk_to_mask`."""
    m = 4
    nbr = torch.tensor([[1, 0, 0], [0, 2, 0], [1, 3, 0], [2, 0, 0]],
                       dtype=torch.int32)
    valid = torch.tensor([[True, False, False], [True, True, False],
                          [True, True, False], [True, False, False]])
    vals, idx, _ = score_topk_sparse(
        torch.ones(m, 4), torch.full((m, 3), -1, dtype=torch.int32),
        torch.ones(m, 3), 0, nbr_idx=nbr, nbr_valid=valid, alpha=1.0,
        lam=0.5, comm_cost=1.0, k=3)
    mask = topk_to_mask(idx, vals, m)
    assert mask[1, 0] and mask[1, 2]
    floor = vals <= NEG / 2
    rows = torch.arange(m)[:, None].expand(m, 3)
    assert torch.equal(idx.long()[floor], rows[floor])
    # k above D pads with (NEG, row) entries
    v5, i5, _ = score_topk_sparse(
        torch.ones(m, 4), torch.full((m, 3), -1, dtype=torch.int32),
        torch.ones(m, 3), 0, nbr_idx=nbr, nbr_valid=valid, alpha=1.0,
        lam=0.5, comm_cost=1.0, k=5)
    assert v5.shape == (m, 5) and (v5[:, 3:] == NEG).all()
    assert torch.equal(i5[:, 3:].long(), torch.arange(m)[:, None].expand(
        m, 2))
    with pytest.raises(ValueError, match="neighbour columns"):
        score_topk_sparse(torch.ones(m, 4), torch.ones(m, 2), torch.ones(
            m, 3), 0, nbr_idx=nbr, nbr_valid=valid, alpha=1.0, lam=0.5,
            comm_cost=1.0, k=2)
