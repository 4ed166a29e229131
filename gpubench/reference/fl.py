"""Plain reference of the federated rounds the benchmark times.

`RefPopulation` holds M clients' parameters (in the configuration's
dtype) and float32 momenta and runs, round by round, with the draws the
benchmark hands the program (participants, batch and probe rows):

PFedDST (arXiv:2502.07750 Algorithm 1): Eq. 6 probe losses of the
sampled rows, Eq. 7 header cosine, Eq. 8 recency, Eq. 9 score
S = s_p (alpha s_l - s_d + c), top-k per row (ties to the lowest
column), the extractor averaged over the selected peers and the client
itself, K_e phase-e steps (header frozen), K_h phase-h steps (extractor
frozen), the loss and recency arrays updated.

A round may follow a selection mask given from outside (the program's,
which the comparison judges against this round's own scores), as a
served model's reference follows the served tokens. The first phase-e
step of each client in the first round is recorded (`first`: its loss,
and its momentum, which is the first gradient as SGD gets it). `fault`
plants one of the faults the benchmark's check has to catch, for the
readings its limits are set from.
"""
from __future__ import annotations

import torch

from gpubench.reference import qwen2, resnet
from gpubench.reference.numerics import DTYPES, Numerics, sgd_step_

NEG = -1e30
MODELS = {"dense": qwen2, "cnn": resnet}
FAULTS = ("half_batch", "half_clients", "no_mix", "altered", "bottom_k")
MIX_BLOCK = 1 << 26


def model_module(model_cfg: dict):
    return MODELS[model_cfg["family"]]


def top_k_mask(scores, k: int):
    """Per-row top-k of (M, M) scores as a bool mask, ties to the lowest
    column; picks at the NEG floor are dropped."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    mask = torch.zeros_like(scores, dtype=torch.bool)
    rows = torch.arange(scores.shape[0], device=scores.device)[:, None]
    mask[rows, idx[:, :k]] = vals[:, :k] > NEG / 2
    return mask


def bottom_k_mask(scores, k: int):
    """The k lowest-scoring peers of each row (the `bottom_k` fault)."""
    eye = torch.eye(scores.shape[0], dtype=torch.bool, device=scores.device)
    return top_k_mask(torch.where(eye, NEG, -scores), k)


def mix_weights(mask):
    """Row-stochastic average over each row's selected peers and itself."""
    w = (mask | torch.eye(mask.shape[0], dtype=torch.bool,
                          device=mask.device)).float()
    return w / w.sum(dim=1, keepdim=True)


class RefPopulation:
    """The reference's population state and rounds (module docstring)."""

    def __init__(self, model_cfg: dict, cell: dict, params: list, data: dict,
                 *, precision: str = "float32", fault: str | None = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.cell, self.fault = model_cfg, cell, fault
        self.model = model_module(model_cfg)
        self.num = Numerics(precision)
        self.fl = cell["fl"]
        self.params = params
        self.data = data
        self.m = len(params)
        if cell["strategy"] != "pfeddst":
            raise ValueError(f"no reference of {cell['strategy']!r}")
        names = list(params[0])
        header = [n for n in names if n.split("/")[0].split(".")[0]
                  in self.model.HEADER]
        self.extractor = [n for n in names if n not in header]
        self.parts = {"e": self.extractor, "h": header}
        dev = params[0][names[0]].device
        self.device = dev
        self.mom = {part: [{n: torch.zeros(params[c][n].shape,
                                           dtype=torch.float32, device=dev)
                            for n in leaves} for c in range(self.m)]
                    for part, leaves in self.parts.items()}
        self.loss_matrix = torch.zeros(self.m, self.m, device=dev)
        self.last = torch.full((self.m, self.m), -1, dtype=torch.int64,
                               device=dev)
        self.t = 0
        self.first = {"loss": {}, "mom": {}}

    # ---- one client --------------------------------------------------------
    def client_batch(self, c: int, idx) -> dict:
        idx = torch.as_tensor(idx, device=self.device).long()
        return {k: v[c][idx] for k, v in self.data.items()}

    def step(self, c: int, part: str, batch: dict) -> float:
        """One SGD step of client c's partition `part` on `batch` (the
        rest frozen); the gradient of the batch mean, accumulated over
        micro-batches. -> the batch's loss before the step."""
        if self.fault == "half_batch":
            half = self.model.batch_rows(batch) // 2
            batch = {k: v[:half] for k, v in batch.items()}
        p = self.params[c]
        trained = self.parts[part]
        live = {n: p[n].to(torch.float32, copy=True).requires_grad_(True)
                for n in trained}
        view = {**p, **live}
        rows = self.model.batch_rows(batch)
        micro = self.cell["reference"]["micro_batch"]
        total = 0.0
        with torch.enable_grad():
            for r0 in range(0, rows, micro):
                mb = {k: v[r0:r0 + micro] for k, v in batch.items()}
                share = self.model.batch_rows(mb) / rows
                loss = self.model.loss(view, mb, self.cfg, self.num) * share
                loss.backward()
                total += float(loss.detach())
        fl = self.fl
        for n in trained:
            sgd_step_(p[n], live[n].grad, self.mom[part][c][n], lr=fl["lr"],
                      momentum=fl["momentum"],
                      weight_decay=fl["weight_decay"])
        del live, view
        if self.t == 0 and part == "e" and c not in self.first["loss"]:
            self.first["loss"][c] = total
            self.first["mom"].update(
                {(c, n): float(self.mom[part][c][n].norm()) for n in trained})
        return total

    @torch.no_grad()
    def probe_losses(self, c: int, probes: dict) -> torch.Tensor:
        """Eq. 6 row: client c's model on every client's probe batch (the
        mean loss over each batch's rows), `chunk` clients' probes to a
        forward. probes: {key: (M, P, ...)}. -> (M,) float32."""
        chunk = self.cell["reference"]["probe_chunk"]
        out = []
        for j0 in range(0, self.m, chunk):
            b = {k: v[j0:j0 + chunk].flatten(0, 1) for k, v in probes.items()}
            nll = self.model.row_nll(self.params[c], b, self.cfg, self.num)
            out.append(nll.view(-1, probes_rows(probes)).mean(1))
        return torch.cat(out)

    @torch.no_grad()
    def mix_(self, names, weights, active):
        """Rows of `active` clients <- sum_j w_ij x_j, leaf by leaf in
        float32 column blocks, cast to the leaf's dtype."""
        rows = active.nonzero().flatten().tolist()
        for n in names:
            flat = [self.params[c][n].view(-1) for c in range(self.m)]
            for c0 in range(0, flat[0].numel(), MIX_BLOCK):
                blk = torch.stack([f[c0:c0 + MIX_BLOCK].float()
                                   for f in flat])
                out = weights[rows] @ blk
                for j, c in enumerate(rows):
                    flat[c][c0:c0 + MIX_BLOCK] = out[j].to(flat[c].dtype)
                del blk, out

    def headers_flat(self):
        return torch.stack([torch.cat([self.params[c][n].reshape(-1).float()
                                       for n in self.parts["h"]])
                            for c in range(self.m)])

    # ---- rounds --------------------------------------------------------
    def _train(self, part, rows, idx) -> float:
        """idx (steps, n, B) rows of each sampled client's data; the mean
        over the clients of the last step's losses."""
        if self.fault == "half_clients":
            rows = rows[:max(1, len(rows) // 2)]
        last = []
        for s in range(idx.shape[0]):
            last = [self.step(c, part, self.client_batch(c, idx[s, j]))
                    for j, c in enumerate(rows)]
        return sum(last) / len(last)

    def _active(self, rows):
        active = torch.zeros(self.m, dtype=torch.bool, device=self.device)
        active[rows] = True
        return active

    def round(self, draws: dict, follow_mask=None) -> dict:
        fl, m, t = self.fl, self.m, self.t
        rows = [int(c) for c in draws["act"]]
        active = self._active(rows)
        pidx = torch.as_tensor(draws["probe"], device=self.device).long()
        ar = torch.arange(m, device=self.device)[:, None]
        probes = {k: v[ar, pidx] for k, v in self.data.items()}
        s_l = self.loss_matrix.clone()
        for c in rows:
            s_l[c] = self.probe_losses(c, probes)
        if self.fault == "altered":   # one row summed over its probe rows
            s_l[rows[0]] *= fl["probe_size"]
        x = self.headers_flat()
        inv = 1.0 / (x.square().sum(1).sqrt() + 1e-12)
        s_d = ((x @ x.T) * inv[:, None] * inv[None, :]).clamp(-1.0, 1.0)
        del x
        dt = (t - self.last).clamp_min(0).float()
        s_p = torch.where(self.last < 0, 1.0,
                          1.0 - torch.exp(-fl["recency_lambda"] * dt))
        eye = torch.eye(m, dtype=torch.bool, device=self.device)
        cost = torch.where(eye, 0.0, float(fl["comm_cost"]))
        scores = torch.where(
            eye, NEG, s_p * (fl["alpha"] * s_l - s_d + cost))
        k = min(fl["peers_per_round"], m - 1)
        pick = bottom_k_mask if self.fault == "bottom_k" else top_k_mask
        own = pick(scores, k) & active[:, None]
        mask = own if follow_mask is None else follow_mask.to(self.device)
        if self.fault != "no_mix":
            self.mix_(self.extractor, mix_weights(mask), active)
        loss_e = self._train("e", rows, draws["e"])
        loss_h = self._train("h", rows, draws["h"])
        self.loss_matrix = torch.where(active[:, None], s_l,
                                       self.loss_matrix)
        self.last = torch.where(mask, t, self.last)
        self.t += 1
        return {"losses": {"train_loss_e": loss_e, "train_loss_h": loss_h},
                "loss_matrix": s_l.cpu(), "scores": scores.cpu(),
                "mask": own.cpu(), "active": active.cpu()}

    # ---- readings --------------------------------------------------------
    @torch.no_grad()
    def momentum_norms(self) -> dict:
        return {(part, c, n): float(t.norm())
                for part, per in self.mom.items()
                for c, leaves in enumerate(per) for n, t in leaves.items()}

    @torch.no_grad()
    def change_norms(self, initial) -> dict:
        """{(client, leaf): ||now - initial||}; initial(c, name) redraws
        the leaf's starting value."""
        out = {}
        for c in range(self.m):
            for n, t in self.params[c].items():
                out[(c, n)] = float((t.float() - initial(c, n).float())
                                    .norm())
        return out


def probes_rows(probes: dict) -> int:
    return next(iter(probes.values())).shape[1]


def storage_dtype(model_cfg: dict):
    return DTYPES[model_cfg.get("dtype", "float32")]
