"""CSR sparse topologies — the port's copy of `repro.comms.sparse`
(numpy, bitwise equal to the reference).

A `SparseTopology` stores the communication graph as packed neighbour
lists (CSR: `indptr`/`indices`), O(M·deg) memory instead of the O(M²)
dense boolean adjacency. The constant-degree generators build CSR
directly, never an (M, M) array, so a 65,536-client hierarchical graph
costs a few MB; `topology.make_topology` derives the dense matrix from
CSR on demand (the small-M oracle).

Directed-slot convention: each undirected link {i, j} occupies two edge
slots (i→j and j→i), as the dense `adj[i, j] = adj[j, i] = True`.
Within a row, `indices` are strictly ascending — the lowest-column
tie-break of a dense top-k, which keeps the packed selection's peer
choice identical to the dense one's.

Generators:
  ring / torus / full   CSR builds of the dense graphs (same edge set)
  hier_ring             clusters of rings: a ring within each contiguous
                        cluster, the clusters' gateways ringed together —
                        degree ≤ 4 at any M
  geo_cell              D2D cells: clients hashed into a g×g grid over
                        the unit square; a ring within each cell and
                        gateway links to the 4 torus-adjacent cells —
                        degree ≤ 6 at any M
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SparseTopology:
    """Packed-edge communication graph.

    m       population size
    indptr  (M+1,) int64 — row r's neighbor slots are
            indices[indptr[r]:indptr[r+1]]
    indices (E,)  int32 — neighbor ids, strictly ascending per row,
            never the row itself
    """
    m: int
    indptr: np.ndarray
    indices: np.ndarray

    def __post_init__(self):
        indptr = np.asarray(self.indptr, np.int64)
        indices = np.asarray(self.indices, np.int32)
        object.__setattr__(self, "indptr", indptr)
        object.__setattr__(self, "indices", indices)
        if indptr.shape != (self.m + 1,) or indptr[0] != 0 \
                or indptr[-1] != indices.size:
            raise ValueError("malformed indptr")
        if indices.size:
            if indices.min() < 0 or indices.max() >= self.m:
                raise ValueError("neighbor index out of range")
            rows = self.edge_rows()
            if (indices == rows).any():
                raise ValueError("self-loop in sparse topology")
            # strictly ascending within each row ⇔ ascending (row, col)
            # keys with no duplicates
            key = rows.astype(np.int64) * self.m + indices
            if (np.diff(key) <= 0).any():
                raise ValueError("indices not strictly ascending per row")

    # -- shape ---------------------------------------------------------------
    @property
    def num_edges(self) -> int:
        """Directed edge slots (each undirected link counts twice)."""
        return int(self.indices.size)

    def degrees(self) -> np.ndarray:
        """(M,) int64 per-row neighbor count."""
        return np.diff(self.indptr)

    @property
    def max_degree(self) -> int:
        return int(self.degrees().max(initial=0))

    def edge_rows(self) -> np.ndarray:
        """(E,) int32 — source row of each edge slot."""
        return np.repeat(
            np.arange(self.m, dtype=np.int32), self.degrees()
        )

    def edge_endpoints(self) -> tuple[np.ndarray, np.ndarray]:
        """(rows (E,), cols (E,)) int32 — both endpoints per edge slot."""
        return self.edge_rows(), self.indices

    def is_symmetric(self) -> bool:
        rows, cols = self.edge_endpoints()
        fwd = rows.astype(np.int64) * self.m + cols
        rev = cols.astype(np.int64) * self.m + rows
        return np.array_equal(fwd, np.sort(rev))

    # -- views ---------------------------------------------------------------
    def padded(self, fill: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """(nbr (M, D) int32, valid (M, D) bool), D = max(max_degree, 1).

        Row r's neighbors occupy slots 0..deg(r)−1 in ascending id order
        (the CSR order); padding slots hold `fill` with valid=False.
        """
        deg = self.degrees()
        d = max(1, self.max_degree)
        nbr = np.full((self.m, d), fill, np.int32)
        rows = self.edge_rows()
        slots = np.arange(self.num_edges) - self.indptr[rows]
        nbr[rows, slots] = self.indices
        valid = np.arange(d)[None, :] < deg[:, None]
        return nbr, valid

    def edge_slots(self) -> tuple[np.ndarray, np.ndarray]:
        """(rows (E,), slots (E,)) — each edge's position in the padded
        (M, D) layout; the static scatter map between per-edge arrays
        and per-slot arrays."""
        rows = self.edge_rows()
        return rows, np.arange(self.num_edges) - self.indptr[rows]

    def dense(self) -> np.ndarray:
        """Materialize the (M, M) boolean adjacency — the small-M oracle.
        O(M²) memory by definition; never called on the scale path."""
        adj = np.zeros((self.m, self.m), dtype=bool)
        rows, cols = self.edge_endpoints()
        adj[rows, cols] = True
        return adj

    @classmethod
    def from_dense(cls, adj: np.ndarray) -> "SparseTopology":
        """Pack a dense boolean adjacency (self-diagonal ignored).
        np.nonzero is row-major, so indices come out ascending per row."""
        adj = np.asarray(adj, bool).copy()
        np.fill_diagonal(adj, False)
        rows, cols = np.nonzero(adj)
        m = adj.shape[0]
        indptr = np.zeros(m + 1, np.int64)
        indptr[1:] = np.cumsum(np.bincount(rows, minlength=m))
        return cls(m=m, indptr=indptr, indices=cols.astype(np.int32))


def csr_from_edges(m: int, rows, cols, *,
                   symmetrize: bool = True) -> SparseTopology:
    """Build a SparseTopology from edge lists: dedup, drop self-loops,
    optionally add the reversed direction. O(E log E)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if symmetrize:
        rows, cols = (np.concatenate([rows, cols]),
                      np.concatenate([cols, rows]))
    keep = rows != cols
    key = np.unique(rows[keep] * m + cols[keep])
    rows, cols = key // m, key % m
    indptr = np.zeros(m + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=m))
    return SparseTopology(m=m, indptr=indptr,
                          indices=cols.astype(np.int32))


# ---------------------------------------------------------------------------
# CSR-direct generators
# ---------------------------------------------------------------------------

def ring_csr(m: int, hops: int = 1) -> SparseTopology:
    """Circulant ±1..hops ring — the CSR build of `topology.ring`."""
    i = np.arange(m)
    rows, cols = [], []
    for h in range(1, min(hops, (m - 1) // 2 + 1) + 1):
        rows += [i, i]
        cols += [(i + h) % m, (i - h) % m]
    if not rows:
        return csr_from_edges(m, [], [])
    return csr_from_edges(m, np.concatenate(rows), np.concatenate(cols))


def torus_csr(m: int) -> SparseTopology:
    """2-D torus on the same r×c grid as `topology.torus`."""
    r = max(d for d in range(1, int(np.sqrt(m)) + 1) if m % d == 0)
    c = m // r
    i = np.arange(m)
    ri, ci = i // c, i % c
    rows = np.concatenate([i, i, i, i])
    cols = np.concatenate([
        ((ri + 1) % r) * c + ci, ((ri - 1) % r) * c + ci,
        ri * c + (ci + 1) % c, ri * c + (ci - 1) % c,
    ])
    return csr_from_edges(m, rows, cols)


def full_csr(m: int) -> SparseTopology:
    """All-pairs graph — O(M²) edges; exists for the small-M oracle only."""
    i = np.arange(m)
    return csr_from_edges(m, np.repeat(i, m), np.tile(i, m))


def hier_ring_csr(m: int, cluster: int) -> SparseTopology:
    """Clusters-of-rings: contiguous clusters of `cluster` clients, a
    ring within each cluster, and a ring over the clusters' gateways
    (each cluster's first member). Degree ≤ 4 at any M — the scale-out
    default for constant-degree gossip populations."""
    cluster = max(2, min(cluster, m)) if m > 1 else 1
    i = np.arange(m)
    cid = i // cluster
    start = cid * cluster
    size = np.minimum(cluster, m - start)
    rows_l, cols_l = [], []
    intra = size >= 2
    if intra.any():
        nxt = start + (i - start + 1) % size
        rows_l.append(i[intra])
        cols_l.append(nxt[intra])
    n_clusters = int(cid[-1]) + 1 if m else 0
    if n_clusters >= 2:
        gw = np.arange(n_clusters) * cluster
        rows_l.append(gw)
        cols_l.append(gw[(np.arange(n_clusters) + 1) % n_clusters])
    if not rows_l:
        return csr_from_edges(m, [], [])
    return csr_from_edges(m, np.concatenate(rows_l),
                          np.concatenate(cols_l))


def geo_cell_csr(m: int, cells: int,
                 rng: np.random.Generator) -> SparseTopology:
    """Geo-cell D2D graph: clients at uniform positions in the unit
    square, hashed into a `cells`×`cells` grid. Within each cell the
    members form a ring (ascending id); each cell's gateway (lowest id)
    links to the gateways of its 4 torus-adjacent nonempty cells.
    Degree ≤ 2 intra + 4 inter = 6 at any M and any occupancy."""
    g = max(1, int(cells))
    pos = rng.random((m, 2))
    cell = np.minimum((pos * g).astype(np.int64), g - 1)
    cell_id = cell[:, 0] * g + cell[:, 1]
    order = np.argsort(cell_id, kind="stable")   # ids ascend within cell
    sorted_cells = cell_id[order]
    starts = np.flatnonzero(
        np.r_[True, sorted_cells[1:] != sorted_cells[:-1]]
    ) if m else np.array([], np.int64)
    ends = np.r_[starts[1:], m] if m else starts
    rows_l, cols_l = [], []
    gateway = {}
    for s, e in zip(starts, ends):
        members = order[s:e]
        gateway[int(sorted_cells[s])] = int(members[0])
        if e - s >= 2:
            rows_l.append(members)
            cols_l.append(np.roll(members, -1))
    for cid, gw in gateway.items():
        x, y = divmod(cid, g)
        for nx, ny in (((x + 1) % g, y), ((x - 1) % g, y),
                       (x, (y + 1) % g), (x, (y - 1) % g)):
            peer = gateway.get(nx * g + ny)
            if peer is not None and peer != gw:
                rows_l.append(np.array([gw]))
                cols_l.append(np.array([peer]))
    if not rows_l:
        return csr_from_edges(m, [], [])
    return csr_from_edges(m, np.concatenate(rows_l),
                          np.concatenate(cols_l))
