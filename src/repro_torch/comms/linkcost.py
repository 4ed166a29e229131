"""Per-link bandwidth / latency / energy model → the Eq. 9 `c` score —
the port's copy of `repro.comms.linkcost` (numpy, bitwise equal to the
reference).

A `LinkModel` holds symmetric (M, M) matrices of link bandwidth (bytes/s),
one-way latency (s) and radio energy (J/byte). Three generators:

  uniform    every link identical (the paper's §III-A equal-cost world)
  hetero     per-client bandwidth tiers (log-uniform over `spread`); a
             link runs at the slower endpoint's tier
  geometric  clients placed in the unit square; latency grows with
             distance and bandwidth decays with it — D2D radio links

`cost_scores` turns link quality into the score-space `c` term of
S = s_p·(α·s_l − s_d + c): c_ij = scale · t_min / t_ij ∈ (0, scale], where
t_ij is the transfer time of a reference payload. Faster links give a
larger c. On a uniform model every off-diagonal entry is exactly `scale`,
the paper's scalar comm_cost. `EdgeLinkModel` holds the same attributes
per CSR edge slot, for the packed fabric.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

REF_PAYLOAD_BYTES = 1 << 20    # 1 MiB blend point for latency vs bandwidth


@dataclass(frozen=True)
class LinkModel:
    bandwidth: np.ndarray     # (M, M) bytes/s, symmetric
    latency_s: np.ndarray     # (M, M) seconds, symmetric
    energy_j_per_byte: np.ndarray  # (M, M) joules/byte, symmetric

    @property
    def num_clients(self) -> int:
        return self.bandwidth.shape[0]

    def transfer_time(self, payload_bytes: float) -> np.ndarray:
        """(M, M) seconds to move `payload_bytes` across each link."""
        return self.latency_s + payload_bytes / self.bandwidth

    def transfer_energy(self, payload_bytes: float) -> np.ndarray:
        """(M, M) joules to move `payload_bytes` across each link."""
        return payload_bytes * self.energy_j_per_byte

    def mean_transfer_time(self, payload_bytes: float) -> float:
        """Mean off-diagonal transfer time (client↔server proxy link)."""
        t = self.transfer_time(payload_bytes)
        off = ~np.eye(self.num_clients, dtype=bool)
        return float(t[off].mean())


def cost_scores(link: LinkModel, scale: float = 1.0) -> np.ndarray:
    """(M, M) float32 `c` matrix for `combined_scores` (diagonal 0)."""
    m = link.num_clients
    t = link.transfer_time(REF_PAYLOAD_BYTES)
    off = ~np.eye(m, dtype=bool)
    t_min = t[off].min()
    c = scale * (t_min / t)
    c[~off] = 0.0
    return c.astype(np.float32)


def scale_by_channel_rate(link: LinkModel, channel_rate) -> LinkModel:
    """Scale a LinkModel by per-client relative channel rates (a device
    profile's channel rates, `fl.hetero.sample_device_vectors`).

    A link runs at the slower endpoint's rate (same convention as
    `hetero_links`): bandwidth scales with `min(rate_i, rate_j)`,
    latency and energy inversely. Uniform rates (all exactly 1.0) leave
    the model bit-for-bit unchanged.
    """
    rate = np.asarray(channel_rate, np.float64)
    if rate.shape != (link.num_clients,):
        raise ValueError(
            f"channel_rate must be ({link.num_clients},), got {rate.shape}"
        )
    pair = np.minimum(rate[:, None], rate[None, :])
    return LinkModel(
        bandwidth=link.bandwidth * pair,
        latency_s=link.latency_s / pair,
        energy_j_per_byte=link.energy_j_per_byte / pair,
    )


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

def uniform_links(m: int, *, bandwidth_bps: float, latency_s: float,
                  energy_j_per_byte: float) -> LinkModel:
    return LinkModel(
        bandwidth=np.full((m, m), bandwidth_bps),
        latency_s=np.full((m, m), latency_s),
        energy_j_per_byte=np.full((m, m), energy_j_per_byte),
    )


def hetero_links(m: int, *, bandwidth_bps: float, latency_s: float,
                 energy_j_per_byte: float, spread: float,
                 rng: np.random.Generator) -> LinkModel:
    """Per-client tier in [1/spread, 1] (log-uniform); a link runs at the
    slower endpoint's tier, and its latency/energy scale inversely."""
    tier = np.exp(rng.uniform(-np.log(spread), 0.0, size=m))
    pair = np.minimum(tier[:, None], tier[None, :])
    return LinkModel(
        bandwidth=bandwidth_bps * pair,
        latency_s=latency_s / pair,
        energy_j_per_byte=energy_j_per_byte / pair,
    )


def geometric_links(m: int, *, bandwidth_bps: float, latency_s: float,
                    energy_j_per_byte: float,
                    rng: np.random.Generator) -> LinkModel:
    """Clients at uniform positions in the unit square. Latency grows
    linearly with distance (mean-normalized); bandwidth and energy decay /
    grow quadratically with it — a free-space path-loss caricature."""
    pos = rng.random((m, 2))
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    off = ~np.eye(m, dtype=bool)
    d_rel = d / max(d[off].mean(), 1e-9)
    np.fill_diagonal(d_rel, 1.0)
    return LinkModel(
        bandwidth=bandwidth_bps / (1.0 + d_rel**2),
        latency_s=latency_s * (0.5 + 0.5 * d_rel),
        energy_j_per_byte=energy_j_per_byte * (1.0 + d_rel**2),
    )


def make_link_model(cfg, m: int) -> LinkModel:
    """Build the LinkModel named by a `CommsConfig`."""
    kw = dict(
        bandwidth_bps=cfg.bandwidth_mbps * 1e6 / 8.0,
        latency_s=cfg.latency_ms * 1e-3,
        energy_j_per_byte=cfg.energy_nj_per_byte * 1e-9,
    )
    rng = np.random.default_rng(cfg.graph_seed + 1)
    if cfg.link_model == "uniform":
        return uniform_links(m, **kw)
    if cfg.link_model == "hetero":
        return hetero_links(m, spread=cfg.hetero_spread, rng=rng, **kw)
    if cfg.link_model == "geometric":
        return geometric_links(m, rng=rng, **kw)
    raise KeyError(
        f"unknown link_model {cfg.link_model!r}; "
        "available: uniform | hetero | geometric"
    )


# ---------------------------------------------------------------------------
# per-edge link model — the O(M·deg) path of the sparse fabric
# ---------------------------------------------------------------------------

# geometric normalizers (the all-pairs mean distance and the global
# minimum transfer time) are O(M²) quantities; below this M they are
# computed exactly from the dense distance matrix — the regime where
# `edge_cost_scores` is bitwise-identical to the dense `cost_scores` —
# and above it from a seeded pair subsample / the edge set (documented
# approximation; uniform and hetero are exact at every M).
GEO_EXACT_MAX = 4096
GEO_SAMPLE_PAIRS = 1 << 20


@dataclass(frozen=True)
class EdgeLinkModel:
    """Link attributes stored per CSR edge slot — (E,) arrays aligned
    with `topo.indices`, built from O(M) per-client primitives (tiers,
    positions) with the SAME arithmetic the dense generators apply
    elementwise, so every per-edge value is bitwise equal to its dense
    (M, M) counterpart at the edge's position.

    `t_min_ref` is the Eq. 9 normalizer: the global (all-pairs,
    off-diagonal) minimum transfer time of the REF payload — NOT the
    minimum over edges, so c columns match the dense `cost_scores`
    exactly. Each family recovers it without the (M, M) matrix: uniform
    links are constant; hetero's min is at the second-largest tier
    (O(M) partition); geometric's is at the minimum pairwise distance
    (exact under GEO_EXACT_MAX, edge-restricted above)."""
    topo: "object"                 # comms.sparse.SparseTopology
    bandwidth: np.ndarray          # (E,) bytes/s
    latency_s: np.ndarray          # (E,) seconds
    energy_j_per_byte: np.ndarray  # (E,) joules/byte
    t_min_ref: float               # global min transfer time @ REF payload

    @property
    def num_edges(self) -> int:
        return int(self.bandwidth.shape[0])

    def transfer_time(self, payload_bytes: float) -> np.ndarray:
        """(E,) seconds to move `payload_bytes` across each edge."""
        return self.latency_s + payload_bytes / self.bandwidth

    def transfer_energy(self, payload_bytes: float) -> np.ndarray:
        """(E,) joules to move `payload_bytes` across each edge."""
        return payload_bytes * self.energy_j_per_byte


def uniform_edges(topo, *, bandwidth_bps: float, latency_s: float,
                  energy_j_per_byte: float) -> EdgeLinkModel:
    e = topo.num_edges
    return EdgeLinkModel(
        topo=topo,
        bandwidth=np.full((e,), bandwidth_bps),
        latency_s=np.full((e,), latency_s),
        energy_j_per_byte=np.full((e,), energy_j_per_byte),
        t_min_ref=latency_s + REF_PAYLOAD_BYTES / bandwidth_bps,
    )


def hetero_edges(topo, *, bandwidth_bps: float, latency_s: float,
                 energy_j_per_byte: float, spread: float,
                 rng: np.random.Generator) -> EdgeLinkModel:
    """Per-edge build of `hetero_links`: same per-client tier draw, the
    pair tier evaluated only at edges. The global t_min sits at the
    largest off-diagonal pair tier = the second-largest client tier
    (transfer time is monotone decreasing in the pair tier)."""
    m = topo.m
    tier = np.exp(rng.uniform(-np.log(spread), 0.0, size=m))
    rows, cols = topo.edge_endpoints()
    pair = np.minimum(tier[rows], tier[cols])
    p2 = np.partition(tier, -2)[-2] if m >= 2 else 1.0
    return EdgeLinkModel(
        topo=topo,
        bandwidth=bandwidth_bps * pair,
        latency_s=latency_s / pair,
        energy_j_per_byte=energy_j_per_byte / pair,
        t_min_ref=latency_s / p2 + REF_PAYLOAD_BYTES / (bandwidth_bps * p2),
    )


def geometric_edges(topo, *, bandwidth_bps: float, latency_s: float,
                    energy_j_per_byte: float,
                    rng: np.random.Generator) -> EdgeLinkModel:
    """Per-edge build of `geometric_links`: same position draw, per-edge
    distances only. The two all-pairs normalizers (mean distance,
    minimum distance) come from the dense matrix under GEO_EXACT_MAX
    (bitwise parity with the dense oracle) and from a seeded pair
    subsample / the edge set above it (documented approximation — at
    that scale there is no dense oracle to match)."""
    m = topo.m
    pos = rng.random((m, 2))
    rows, cols = topo.edge_endpoints()
    d_e = np.linalg.norm(pos[rows] - pos[cols], axis=-1)
    if m <= GEO_EXACT_MAX:
        d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
        off = ~np.eye(m, dtype=bool)
        d_mean = max(d[off].mean(), 1e-9)
        d_min_rel = d[off].min() / d_mean
    else:
        i = rng.integers(0, m, size=GEO_SAMPLE_PAIRS)
        j = rng.integers(0, m, size=GEO_SAMPLE_PAIRS)
        keep = i != j
        d_mean = max(
            np.linalg.norm(pos[i[keep]] - pos[j[keep]], axis=-1).mean(),
            1e-9,
        )
        d_min_rel = (d_e.min() if d_e.size else 1.0) / d_mean
    d_rel = d_e / d_mean
    # the dense t matrix is monotone increasing in d_rel, so its
    # off-diagonal minimum is the entry at the minimum distance —
    # recomputed here with the same elementwise expressions
    b_min = bandwidth_bps / (1.0 + d_min_rel**2)
    t_min = latency_s * (0.5 + 0.5 * d_min_rel) + REF_PAYLOAD_BYTES / b_min
    return EdgeLinkModel(
        topo=topo,
        bandwidth=bandwidth_bps / (1.0 + d_rel**2),
        latency_s=latency_s * (0.5 + 0.5 * d_rel),
        energy_j_per_byte=energy_j_per_byte * (1.0 + d_rel**2),
        t_min_ref=t_min,
    )


def edge_cost_scores(elink: EdgeLinkModel, scale: float = 1.0) -> np.ndarray:
    """(E,) float32 Eq. 9 `c` values — `cost_scores` per edge slot:
    c_e = scale · t_min / t_e with the GLOBAL t_min normalizer, so each
    value is bitwise equal to the dense matrix entry at (row_e, col_e)
    (exact for uniform/hetero at any M, geometric under GEO_EXACT_MAX).
    """
    t = elink.transfer_time(REF_PAYLOAD_BYTES)
    return (scale * (elink.t_min_ref / t)).astype(np.float32)


def make_edge_link_model(cfg, topo) -> EdgeLinkModel:
    """Per-edge EdgeLinkModel named by a `CommsConfig` — same RNG stream
    as `make_link_model` (graph_seed + 1), so the per-client primitives
    (tiers, positions) are the very draws the dense model uses."""
    kw = dict(
        bandwidth_bps=cfg.bandwidth_mbps * 1e6 / 8.0,
        latency_s=cfg.latency_ms * 1e-3,
        energy_j_per_byte=cfg.energy_nj_per_byte * 1e-9,
    )
    rng = np.random.default_rng(cfg.graph_seed + 1)
    if cfg.link_model == "uniform":
        return uniform_edges(topo, **kw)
    if cfg.link_model == "hetero":
        return hetero_edges(topo, spread=cfg.hetero_spread, rng=rng, **kw)
    if cfg.link_model == "geometric":
        return geometric_edges(topo, rng=rng, **kw)
    raise KeyError(
        f"unknown link_model {cfg.link_model!r}; "
        "available: uniform | hetero | geometric"
    )
