"""CommsFabric — topology, links, events and transport in one object; the
port's copy of `repro.comms.fabric`.

Built once per experiment from a `CommsConfig`, on the round's device,
and used in two places:

  inside the round (torch, on the device):
      cand, avail, stale = fabric.round_masks(streams, affinity=...)
      scores = combined_scores(..., comm_cost=fabric.cost)

  after the round, on the host (exact numpy accounting):
      stats = fabric.account_round(pattern, metrics, payload_bytes)

`streams` are the round's network generators (`NET_STREAMS`, from
`fl.engine.net_streams`). With the default `CommsConfig` (full topology,
uniform links, no events) the fabric is the paper's §III-A equal-cost
world exactly: `cost` is `scale` at every off-diagonal entry and
`round_masks` returns the all-pairs candidate mask, drawing nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comms import events as events_mod
from repro_torch.comms import topology as topo_mod
from repro_torch.comms.linkcost import (
    EdgeLinkModel,
    LinkModel,
    cost_scores,
    edge_cost_scores,
    make_edge_link_model,
    make_link_model,
    scale_by_channel_rate,
)
from repro_torch.comms.transport import (
    TrafficStats,
    simulate_exchange,
    simulate_exchange_edges,
    star_exchange,
)
from repro_torch.device import resolve_device

# largest M at which the sparse fabric will materialize a dense (M, M)
# oracle view (cand_dense / cost): 8192² bools ≈ 64 MB. Above it the
# dense views raise — every consumer must be on the packed path by then.
DENSE_ORACLE_MAX = 8192

# the round's network generators: the dynamic adjacency's planes, then one
# per event (comms.events)
NET_STREAMS = ("adj", "drop", "avail", "stale")


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _round_edges(metrics: dict, pattern: str, name: str):
    edges = metrics.get("comm_edges", metrics.get("select_mask"))
    if edges is None:
        raise KeyError(
            f"strategy {name!r} has comm_pattern {pattern!r} but emitted "
            "neither 'comm_edges' nor 'select_mask' in its round metrics")
    return _host(edges)


class CommsFabric:
    def __init__(self, cfg, m: int, *, cost_scale: float = 1.0,
                 channel_rate=None, device="cuda"):
        """cfg: CommsConfig; m: population size; cost_scale: the paper's
        scalar comm_cost c (the uniform network's value of the c matrix);
        channel_rate: optional (M,) per-client relative link rates;
        device: where the round's tensors (`cost`, `static_adj`) live."""
        device = resolve_device(device)
        self.cfg = cfg
        self.m = m
        link = make_link_model(cfg, m)
        if channel_rate is not None:
            link = scale_by_channel_rate(link, channel_rate)
        self.link: LinkModel = link
        self.cost = torch.from_numpy(cost_scores(link, cost_scale)).to(device)
        adj = topo_mod.make_topology(cfg.topology, m, cfg=cfg,
                                     seed=cfg.graph_seed)
        self.static_adj = (None if adj is None
                           else torch.from_numpy(adj).to(device))

    @property
    def is_dynamic(self) -> bool:
        return self.static_adj is None

    # -- round side (torch) ------------------------------------------------
    def adjacency(self, generator=None, affinity=None):
        """This round's (M, M) bool adjacency (before events)."""
        if not self.is_dynamic:
            return self.static_adj
        if affinity is None:
            affinity = torch.zeros((self.m, self.m), device=self.cost.device)
        return topo_mod.dynamic_topk(affinity, self.cfg.dyn_degree,
                                     generator, explore=self.cfg.dyn_explore)

    def round_masks(self, streams: dict, *, affinity=None):
        """(candidate_mask (M, M), available (M,), staleness (M,))."""
        adj = self.adjacency(streams["adj"], affinity)
        return events_mod.apply_events(streams, adj, self.cfg)

    # -- host-side accounting ------------------------------------------------
    def account_round(self, pattern: str, metrics: dict,
                      payload_bytes: int, *, name: str = "") -> TrafficStats:
        """Price one round from its metrics: "star" bills each client in
        metrics["active"] one upload and one download; "p2p" prices the
        round's edges (metrics["comm_edges"], or "select_mask")."""
        if pattern == "star":
            return self.star_account(_host(metrics["active"]),
                                     up_bytes=payload_bytes,
                                     down_bytes=payload_bytes)
        return self.account(_round_edges(metrics, pattern, name),
                            payload_bytes)

    def account(self, edges, payload_bytes: int) -> TrafficStats:
        """Gossip exchange over `edges` (i pulls j ⇔ edges[i, j])."""
        return simulate_exchange(self.link, _host(edges), payload_bytes)

    def star_account(self, active, *, up_bytes: int,
                     down_bytes: int) -> TrafficStats:
        """Client↔server exchange of the centralized baselines."""
        return star_exchange(self.link, _host(active), up_bytes=up_bytes,
                             down_bytes=down_bytes)


class SparseFabric:
    """Large-M fabric: CSR topology and per-edge links, O(M·deg) memory.
    The engine detects `round_slots` and hands the packed neighbour view
    (`RoundContext.nbr`) to the packed Eq. 9 selection; the dense (M, M)
    views (`cand_dense`, `cost`) are small-M oracles and refuse to form
    past DENSE_ORACLE_MAX.

    Not a drop-in for every CommsFabric use:
      * dynamic topologies have no static CSR (ValueError at build);
      * star accounting prices a client↔server proxy over the all-pairs
        mean link, with no edge-set analogue (ValueError at accounting);
      * device-profile channel_rate scaling is dense-fabric only.

    Parity: topology, per-edge links, Eq. 9 cost columns, degree bounds
    and the (M,) availability and staleness draws equal the dense
    fabric's; dropout is pair-keyed (`events.drop_links_pairfold` is its
    dense oracle), so the two fabrics' rounds agree at p_link_drop = 0.
    """

    is_dynamic = False

    def __init__(self, cfg, m: int, *, cost_scale: float = 1.0,
                 channel_rate=None, device="cuda"):
        if channel_rate is not None:
            raise NotImplementedError(
                "SparseFabric does not support device-profile channel_rate "
                "scaling; use the dense CommsFabric (CommsConfig.sparse="
                "False)")
        topo = topo_mod.make_sparse_topology(cfg.topology, m, cfg=cfg,
                                             seed=cfg.graph_seed)
        if topo is None:
            raise ValueError("dynamic topology has no static CSR (resampled "
                             "every round); use the dense CommsFabric")
        device = resolve_device(device)
        self.cfg = cfg
        self.m = m
        self.topo = topo
        self.elink: EdgeLinkModel = make_edge_link_model(cfg, topo)
        edge_cost = edge_cost_scores(self.elink, cost_scale)
        self.edge_cost = torch.from_numpy(edge_cost).to(device)
        nbr, valid = topo.padded()
        self.nbr_idx = torch.from_numpy(nbr).to(device)     # (M, D) int32
        self.nbr_static = torch.from_numpy(valid).to(device)
        rows, slots = topo.edge_slots()
        self._edge_rows = torch.from_numpy(rows).to(device, torch.int64)
        self._edge_cols = torch.from_numpy(topo.indices).to(device,
                                                            torch.int64)
        self._edge_slots = torch.from_numpy(slots).to(device, torch.int64)
        slot_cost = np.zeros(valid.shape, np.float32)
        slot_cost[rows, slots] = edge_cost
        self.slot_cost = torch.from_numpy(slot_cost).to(device)  # (M, D)
        self._cost_dense = None

    @property
    def degree_bound(self) -> int:
        """Static max row degree — what topology_degree_bound returns."""
        return self.topo.max_degree

    # -- round side (torch) ------------------------------------------------
    def round_slots(self, streams: dict):
        """((M, D) slot mask, available (M,), staleness (M,)) — the packed
        analogue of `round_masks`, from the same streams."""
        keep, avail, stale = events_mod.apply_events_sparse(
            streams, self._edge_rows, self._edge_cols, self.m, self.cfg)
        slot_mask = torch.zeros(self.nbr_static.shape, dtype=torch.bool,
                                device=keep.device)
        slot_mask[self._edge_rows, self._edge_slots] = keep
        return slot_mask, avail, stale

    def round_masks(self, streams: dict, *, affinity=None):
        """CommsFabric-compatible dense view of `round_slots`."""
        del affinity                             # static graph
        slot_mask, avail, stale = self.round_slots(streams)
        return self.cand_dense(slot_mask), avail, stale

    def cand_dense(self, slot_mask):
        """Scatter a per-slot round mask into the (M, M) candidate matrix
        (small-M oracle only)."""
        self._check_dense("cand_dense")
        rows = self._edge_rows
        cand = torch.zeros((self.m, self.m), dtype=torch.bool,
                           device=slot_mask.device)
        cand[rows, self._edge_cols] = slot_mask[rows, self._edge_slots]
        return cand

    @property
    def cost(self):
        """Dense Eq. 9 `c` oracle: per-edge costs scattered into (M, M),
        zeros elsewhere (selection always ANDs with the candidate mask, a
        subset of the edge set, so off-edge entries are never read)."""
        self._check_dense("cost")
        if self._cost_dense is None:
            c = torch.zeros((self.m, self.m), device=self.edge_cost.device)
            c[self._edge_rows, self._edge_cols] = self.edge_cost
            self._cost_dense = c
        return self._cost_dense

    def _check_dense(self, what: str):
        if self.m > DENSE_ORACLE_MAX:
            raise RuntimeError(
                f"SparseFabric.{what} would materialize an ({self.m}, "
                f"{self.m}) array (M > DENSE_ORACLE_MAX={DENSE_ORACLE_MAX});"
                " large-M consumers must use the packed views (nbr_idx / "
                "slot_cost / round_slots)")

    # -- host-side accounting ------------------------------------------------
    def account_round(self, pattern: str, metrics: dict,
                      payload_bytes: int, *, name: str = "") -> TrafficStats:
        """Price one round — p2p gossip only (see the class docstring)."""
        if pattern != "p2p":
            raise ValueError(
                f"SparseFabric prices p2p gossip only; strategy {name!r} has "
                f"comm_pattern {pattern!r} — use the dense CommsFabric "
                "(CommsConfig.sparse=False) for star baselines")
        return self.account(_round_edges(metrics, pattern, name),
                            payload_bytes)

    def account(self, edges, payload_bytes: int) -> TrafficStats:
        """Gossip accounting. `edges` is a per-edge (E,) activity mask, or
        a dense (M, M) mask from the round's plan, gathered onto the edge
        set; a priced pair outside the topology raises (the plan is cut to
        the candidate mask, a subset of the edge set)."""
        edges = _host(edges)
        if edges.ndim == 1:
            edge_active = edges.astype(bool)
        else:
            rows, cols = self.topo.edge_endpoints()
            edge_active = edges[rows, cols].astype(bool)
            if int(edge_active.sum()) != int(edges.sum()):
                raise ValueError(
                    "round edges contain pairs outside the sparse topology "
                    "— the plan was not cut to the fabric's candidate mask")
        return simulate_exchange_edges(self.elink, edge_active,
                                       payload_bytes)


def make_fabric(comms_cfg, m: int, *, cost_scale: float = 1.0,
                channel_rate=None, device="cuda"):
    """The fabric of a CommsConfig on `device` — `CommsConfig.sparse`
    selects the packed SparseFabric; None keeps the scalar path."""
    if comms_cfg is None:
        return None
    cls = SparseFabric if comms_cfg.sparse else CommsFabric
    return cls(comms_cfg, m, cost_scale=cost_scale,
               channel_rate=channel_rate, device=device)
