"""Simulated gossip transport — the port's copy of
`repro.comms.transport` (numpy on the host; bitwise equal to the
reference).

Given the round's selected edges (edges[i, j] ⇔ client i pulls peer j's
extractor) and a per-message payload size, produce exact per-client traffic
accounting and a simulated wall-clock for the exchange:

  bytes     integer-exact: messages × payload (the payload from the tree's
            byte counts, `utils.pytree`, optionally quantization-aware)
  time      per-link time from the LinkModel; transfers at one client are
            serialized on its NIC (time_i = Σ its transfers), clients run
            in parallel → round time = max over clients of
            max(inbound_i, outbound_i)
  energy    Σ over transfers of payload × link J/byte

`star_exchange` models the centralized baselines (fedavg, fedper,
fedbabu): each active client uploads and downloads over a proxy link with
the mean off-diagonal characteristics; the server's NIC is unconstrained.

Accounting scope: the parameter exchange only. PFedDST's score context
(Eq. 6 probe batches, Eq. 7 header vectors) is not priced.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.comms.linkcost import LinkModel
from repro_torch.utils.pytree import tree_bytes, tree_size


@dataclass(frozen=True)
class TrafficStats:
    """One round's network activity (all exact integers except time/energy)."""
    bytes_sent: np.ndarray   # (M,) int64 per-client uplink bytes
    bytes_recv: np.ndarray   # (M,) int64 per-client downlink bytes
    messages: int
    sim_time_s: float        # simulated wall-clock of the exchange
    energy_j: float
    # bytes moved over the network, each payload counted once. Not
    # derivable from bytes_sent alone: gossip transfers appear in both a
    # sender's sent and a receiver's recv, while star downlinks appear
    # only in clients' recv (the server is not a client).
    wire_bytes: int = 0

    @property
    def total_bytes(self) -> int:
        return self.wire_bytes

    @staticmethod
    def zero(m: int) -> "TrafficStats":
        z = np.zeros((m,), np.int64)
        return TrafficStats(z, z.copy(), 0, 0.0, 0.0, 0)


def payload_bytes_per_client(stacked_tree, num_clients: int, *,
                             bits: int = 0, overhead_bytes: int = 0) -> int:
    """Wire size of ONE client's slice of a leading-M stacked tree of
    tensors.

    bits == 0 → native dtype bytes (tree_bytes / M, exact: every leaf
    carries the M axis). bits > 0 → quantization-aware: ceil(params ·
    bits / 8). `overhead_bytes` adds fixed per-message framing.
    """
    if bits:
        per = math.ceil(tree_size(stacked_tree) // num_clients * bits / 8)
    else:
        per = tree_bytes(stacked_tree) // num_clients
    return per + overhead_bytes


def simulate_exchange(link: LinkModel, edges: np.ndarray,
                      payload_bytes: int) -> TrafficStats:
    """Run one gossip round: every edge (i ← j) moves `payload_bytes`."""
    edges = np.asarray(edges, dtype=bool)
    m = link.num_clients
    recv = edges.sum(axis=1).astype(np.int64) * payload_bytes
    sent = edges.sum(axis=0).astype(np.int64) * payload_bytes
    t = link.transfer_time(payload_bytes)
    per_edge = np.where(edges, t, 0.0)
    inbound = per_edge.sum(axis=1)
    outbound = per_edge.sum(axis=0)
    sim_time = float(np.maximum(inbound, outbound).max()) if edges.any() \
        else 0.0
    energy = float(np.where(edges, link.transfer_energy(payload_bytes), 0.0)
                   .sum())
    return TrafficStats(
        bytes_sent=sent, bytes_recv=recv, messages=int(edges.sum()),
        sim_time_s=sim_time, energy_j=energy,
        wire_bytes=int(edges.sum()) * payload_bytes,
    )


def simulate_exchange_edges(elink, edge_active,
                            payload_bytes: int) -> TrafficStats:
    """Per-edge gossip accounting on an `EdgeLinkModel` — the O(E) path
    of `simulate_exchange` for the sparse fabric. `edge_active[e]` marks
    edge slot e (row pulls col) as exercised this round.

    Byte/message/energy totals are exact and equal to the dense path's;
    per-client NIC times accumulate in CSR edge order instead of dense
    row order, so `sim_time_s` matches at fp tolerance (allclose), not
    bitwise.
    """
    act = np.asarray(edge_active, bool)
    topo = elink.topo
    m = topo.m
    rows, cols = topo.edge_endpoints()
    rows, cols = rows[act], cols[act]
    n = int(rows.size)
    recv = np.bincount(rows, minlength=m).astype(np.int64) * payload_bytes
    sent = np.bincount(cols, minlength=m).astype(np.int64) * payload_bytes
    if n == 0:
        return TrafficStats(sent, recv, 0, 0.0, 0.0, 0)
    t = elink.transfer_time(payload_bytes)[act]
    inbound = np.bincount(rows, weights=t, minlength=m)
    outbound = np.bincount(cols, weights=t, minlength=m)
    sim_time = float(np.maximum(inbound, outbound).max())
    energy = float(elink.transfer_energy(payload_bytes)[act].sum())
    return TrafficStats(
        bytes_sent=sent, bytes_recv=recv, messages=n,
        sim_time_s=sim_time, energy_j=energy,
        wire_bytes=n * payload_bytes,
    )


def star_exchange(link: LinkModel, active: np.ndarray, *,
                  up_bytes: int, down_bytes: int) -> TrafficStats:
    """Client↔server round for the centralized baselines.

    Only ACTIVE clients are billed (one download + one upload each), even
    though the simulator broadcasts the average into every client's row:
    those rows represent the server-held global model, not a transmission
    — a client pays the download in each round it participates, exactly
    the real protocol. Evaluating the global model on all clients' test
    sets is a measurement construct and moves no bytes.
    """
    active = np.asarray(active, dtype=bool)
    m = link.num_clients
    sent = np.where(active, up_bytes, 0).astype(np.int64)
    recv = np.where(active, down_bytes, 0).astype(np.int64)
    n = int(active.sum())
    if n == 0:
        return TrafficStats.zero(m)
    t_up = link.mean_transfer_time(up_bytes)
    t_down = link.mean_transfer_time(down_bytes)
    e_scale = float(link.energy_j_per_byte[~np.eye(m, dtype=bool)].mean())
    return TrafficStats(
        bytes_sent=sent, bytes_recv=recv, messages=2 * n,
        sim_time_s=t_up + t_down,
        energy_j=n * (up_bytes + down_bytes) * e_scale,
        wire_bytes=n * (up_bytes + down_bytes),
    )
