"""Selection introspection — the dense Eq. 9 decomposition and the peer
graph, reference `repro.obs.selection_probe`.

The fused `select_topk` kernel keeps the Eq. 9 score in registers: only
(M, k) top-k values and indices leave it, so nobody can see why client i
pulled peer j. This module is the opt-in dense side-channel:

* `decompose_scores` — the full (M, M) decomposition of Eq. 9 into its
  s_l / s_d / s_p / cost components and the masked combined scores, from
  the kernel's definition of correctness (`kernels.ref.select_score_ref`).
  O(M²) by construction: probe-only.
* `probe_topk` / `check_fused_parity` — the stable top-k of the probe's
  scores, and the assertion that it matches the kernel's (M, k) output:
  indices exactly, values at a tolerance.
* `SelectionGraph` — the selection-frequency matrix across rounds, the
  round-over-round churn (1 − Jaccard) and the peer graph as an edge
  list (JSON, trace record).

The always-on counterpart is `core.scoring.selected_components`, which
decomposes the selected (M, k) pairs only — the `sel_*_mean` metrics of
every PFedDST round.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.core.scoring import recency_scores, selected_components
from repro_torch.core.selection import as_cost_matrix
from repro_torch.kernels.ref import select_score_ref, stable_topk


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def decompose_scores(headers_flat, last_selected, loss_matrix, round_t, *,
                     alpha: float, lam: float, comm_cost,
                     candidate_mask=None) -> dict:
    """The full dense Eq. 9 decomposition → dict of (M, M) float32
    tensors: s_l, s_d, s_p, cost, and the masked combined `scores` (the
    diagonal and non-candidates at NEG, as the selection sees them)."""
    m = headers_flat.shape[0]
    device = headers_flat.device
    scores, s_d = select_score_ref(headers_flat, last_selected, loss_matrix,
                                   round_t, comm_cost, candidate_mask,
                                   alpha=alpha, lam=lam)
    return {
        "s_l": loss_matrix.float(),
        "s_d": s_d,
        "s_p": recency_scores(last_selected, round_t, lam),
        "cost": as_cost_matrix(comm_cost, m, device),
        "scores": scores,
    }


def probe_topk(decomposition: dict, k: int):
    """The stable top-k (ties to the lowest column, as the kernel) of the
    probe's dense scores → (values, int64 indices)."""
    return stable_topk(decomposition["scores"], k)


def check_fused_parity(decomposition: dict, fused_vals, fused_idx, *,
                       atol: float = 1e-5):
    """Assert the dense probe reproduces the fused kernel's selection:
    indices exactly, values to `atol`. Raises AssertionError otherwise."""
    vals, idx = probe_topk(decomposition, fused_idx.shape[1])
    np.testing.assert_array_equal(_numpy(idx), _numpy(fused_idx))
    np.testing.assert_allclose(_numpy(vals), _numpy(fused_vals), atol=atol)


def components_of_selected(decomposition: dict, idx, *,
                           alpha: float) -> dict:
    """The dense probe's components at the selected (M, k) pairs — the
    keys of `core.scoring.selected_components` — with the score
    recombined from them."""
    idx = idx.long()
    out = {name: torch.gather(decomposition[name], 1, idx)
           for name in ("s_l", "s_d", "s_p", "cost")}
    out["score"] = out["s_p"] * (alpha * out["s_l"] - out["s_d"]
                                 + out["cost"])
    return out


class SelectionGraph:
    """Cumulative who-selected-whom graph over an experiment.

    observe(mask_or_edges) per round → frequency counts, per-round edge
    sets, and round-over-round churn (1 − Jaccard of consecutive edge
    sets; 0.0 for the first observed round). Masks may be tensors on any
    device or numpy arrays.

    adversaries: optional (M,) bool cast annotation (`repro_torch.
    openworld`), exported in the record so the frequency view can be
    split into honest→honest and honest→adversary edges offline; it never
    affects the counts.
    """

    def __init__(self, m: int, adversaries=None):
        self.m = int(m)
        self.counts = np.zeros((m, m), np.int64)
        self.rounds = 0
        self.churn: list = []
        self._prev: set | None = None
        self.adversaries = (None if adversaries is None else
                            np.asarray(_numpy(adversaries), bool).reshape(m))

    @staticmethod
    def _to_edges(mask_or_edges) -> set:
        arr = _numpy(mask_or_edges)
        if arr.ndim == 2 and arr.dtype != bool and arr.shape[1] == 2:
            return {(int(i), int(j)) for i, j in arr}
        ii, jj = np.nonzero(np.asarray(arr, bool))
        return {(int(i), int(j)) for i, j in zip(ii, jj)}

    def observe(self, mask_or_edges) -> set:
        edges = self._to_edges(mask_or_edges)
        for i, j in edges:
            self.counts[i, j] += 1
        if self._prev is None:
            self.churn.append(0.0)
        else:
            union = self._prev | edges
            inter = self._prev & edges
            self.churn.append(1.0 - (len(inter) / len(union))
                              if union else 0.0)
        self._prev = edges
        self.rounds += 1
        return edges

    def edge_list(self) -> list:
        """[[i, j, count], ...] for every edge selected at least once,
        by descending count, then (i, j)."""
        ii, jj = np.nonzero(self.counts)
        edges = [[int(i), int(j), int(self.counts[i, j])]
                 for i, j in zip(ii, jj)]
        return sorted(edges, key=lambda e: (-e[2], e[0], e[1]))

    def frequency(self) -> np.ndarray:
        """(M, M) float selection frequency (counts / observed rounds)."""
        return self.counts / max(self.rounds, 1)

    def to_record(self) -> dict:
        """The trace's `selection_graph` record (obs/trace schema; the
        optional `adversaries` key is additive: the validator checks the
        required keys only)."""
        rec = {"type": "selection_graph", "num_clients": self.m,
               "rounds": self.rounds, "edges": self.edge_list(),
               "churn": [round(float(c), 6) for c in self.churn]}
        if self.adversaries is not None:
            rec["adversaries"] = [int(i)
                                  for i in np.flatnonzero(self.adversaries)]
        return rec

    def export_json(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.to_record(), fh, indent=1)


__all__ = [
    "decompose_scores",
    "probe_topk",
    "check_fused_parity",
    "components_of_selected",
    "selected_components",
    "SelectionGraph",
]
