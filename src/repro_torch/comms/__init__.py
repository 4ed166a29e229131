"""repro_torch.comms — the decentralized communication fabric, the
port's copy of `repro.comms`.

Who can talk to whom (`topology`, canonically the CSR
`sparse.SparseTopology`), what each link costs (`linkcost` → the Eq. 9
`c` matrix, per edge on the packed path), what a round's exchange moves
and how long it takes (`transport`), and what the network does to
participation (`events`). `fabric.CommsFabric` ties the four together
densely; `fabric.SparseFabric` is the O(M·deg) packed-edge build for large
populations. `configs.base.CommsConfig` holds every knob. Topologies,
links, costs and the transport are numpy and equal the reference bitwise;
the events draw from torch generators (same distributions, other bits).
"""
from repro_torch.comms.fabric import (
    DENSE_ORACLE_MAX,
    NET_STREAMS,
    CommsFabric,
    SparseFabric,
    make_fabric,
)
from repro_torch.comms.linkcost import (
    EdgeLinkModel,
    LinkModel,
    cost_scores,
    edge_cost_scores,
    geometric_edges,
    geometric_links,
    hetero_edges,
    hetero_links,
    make_edge_link_model,
    make_link_model,
    uniform_edges,
    uniform_links,
)
from repro_torch.comms.sparse import (
    SparseTopology,
    csr_from_edges,
    full_csr,
    geo_cell_csr,
    hier_ring_csr,
    ring_csr,
    torus_csr,
)
from repro_torch.comms.topology import (
    TOPOLOGIES,
    dynamic_topk,
    erdos_renyi,
    fully_connected,
    make_sparse_topology,
    make_topology,
    ring,
    small_world,
    topology_degree_bound,
    torus,
)
from repro_torch.comms.transport import (
    TrafficStats,
    payload_bytes_per_client,
    simulate_exchange,
    simulate_exchange_edges,
    star_exchange,
)
from repro_torch.comms.events import (
    apply_events,
    apply_events_sparse,
    availability_mask,
    drop_edges,
    drop_links,
    drop_links_pairfold,
    edge_pair_uniform,
    staleness_rounds,
)

__all__ = [
    "CommsFabric", "SparseFabric", "make_fabric", "DENSE_ORACLE_MAX",
    "NET_STREAMS",
    "LinkModel", "EdgeLinkModel", "cost_scores", "edge_cost_scores",
    "uniform_links", "hetero_links", "geometric_links", "make_link_model",
    "uniform_edges", "hetero_edges", "geometric_edges",
    "make_edge_link_model",
    "SparseTopology", "csr_from_edges", "ring_csr", "torus_csr",
    "full_csr", "hier_ring_csr", "geo_cell_csr",
    "TOPOLOGIES", "make_topology", "make_sparse_topology",
    "topology_degree_bound", "fully_connected", "ring", "torus",
    "erdos_renyi", "small_world", "dynamic_topk", "TrafficStats",
    "payload_bytes_per_client", "simulate_exchange",
    "simulate_exchange_edges", "star_exchange",
    "apply_events", "apply_events_sparse", "availability_mask",
    "drop_links", "drop_edges", "drop_links_pairfold",
    "edge_pair_uniform", "staleness_rounds",
]
