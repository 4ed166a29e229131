"""Step functions of the training and serving entry points, reference
`repro.launch.steps`.

  make_train_pair_step  one phase-e then one phase-h step of one client
                        (the paper's alternating partial-freeze cycle,
                        Eq. 3 → 4)
  make_fed_round_step   the whole PFedDST round in population mode:
                        Eq. 6 over every client's probe, Eq. 7 by
                        `header_gram_tree`, Eq. 8, the Eq. 9 top-k,
                        aggregation, then one phase-e and one phase-h step
                        per client
  make_prefill_step     logits and the cache (logits alone for the vlm
                        family and the recurrent families)
  make_serve_step       one decode token against the cache

The reference vmaps the client axis and shards it over pods; here the
population axis is a loop on one device, as in `fl.engine.make_round`.
The training steps default to backend "chunked" and remat, as the
reference's do (both run plain PyTorch: the kernels have no backward).
Every step is functional: it returns new trees.
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregation import (aggregate_extractors,
                                          selection_to_weights)
from repro_torch.core.client_state import client_rows, stack_trees
from repro_torch.core.partial_freeze import make_phase_steps
from repro_torch.core.scoring import (header_gram_tree, loss_disparity_rows,
                                      recency_scores)
from repro_torch.core.selection import (combined_scores, select_peers,
                                        update_recency)
from repro_torch.models import model as model_mod
from repro_torch.models.split import merge_params


def make_train_pair_step(cfg, opt_e, opt_h, *, backend="chunked",
                         remat=True):
    """(extractor, header, opt_e_state, opt_h_state, batch) → (e, h, oe,
    oh, {"loss_e", "loss_h"}): phase e, then phase h on the new
    extractor."""
    steps = make_phase_steps(cfg, opt_e, opt_h, backend=backend, remat=remat)

    def train_step(extractor, header, opt_e_state, opt_h_state, batch):
        e, oe, m_e = steps.phase_e(extractor, header, opt_e_state, batch)
        h, oh, m_h = steps.phase_h(e, header, opt_h_state, batch)
        return e, h, oe, oh, {"loss_e": m_e["loss"], "loss_h": m_h["loss"]}

    return train_step


def make_fed_round_step(cfg, fl, opt_e, opt_h, *, backend="chunked",
                        remat=True):
    """One communication round over M clients (leading M axis on every
    tree):

      (extractor, header, opt_e_state, opt_h_state, last_selected (M, M)
       int32, rnd 0-d int32, probe_batch {"tokens": (M, Bp, S)},
       train_batch {"tokens": (M, Bt, S)})
      → (extractor, header, opt_e_state, opt_h_state, last_selected,
         rnd + 1, {"loss_e", "loss_h", "mean_score"})"""
    steps = make_phase_steps(cfg, opt_e, opt_h, backend=backend, remat=remat)

    def fed_round_step(extractor, header, opt_e_state, opt_h_state,
                       last_selected, rnd, probe_batch, train_batch):
        m = last_selected.shape[0]
        # ---- 1. scoring (Eq. 6/7/8 → 9) -----------------------------------
        params = merge_params(extractor, header)
        s_l = loss_disparity_rows(cfg, params, probe_batch)
        s_d = header_gram_tree(header)
        s_p = recency_scores(last_selected, rnd, fl.recency_lambda)
        scores = combined_scores(s_l, s_d, s_p, alpha=fl.alpha,
                                 comm_cost=fl.comm_cost)
        # ---- 2/3. select + aggregate --------------------------------------
        mask = select_peers(scores, k=min(fl.peers_per_round, m - 1))
        weights = selection_to_weights(mask, include_self=True)
        agg_e = aggregate_extractors(extractor, weights)
        # ---- 4/5. one phase-e + one phase-h step per client ---------------
        outs_e, outs_h = [], []
        for i in range(m):
            batch = {k: v[i] for k, v in train_batch.items()}
            outs_e.append(steps.phase_e(client_rows(agg_e, i),
                                        client_rows(header, i),
                                        client_rows(opt_e_state, i), batch))
            outs_h.append(steps.phase_h(outs_e[-1][0],
                                        client_rows(header, i),
                                        client_rows(opt_h_state, i), batch))
        new_e = stack_trees([o[0] for o in outs_e])
        oe = stack_trees([o[1] for o in outs_e])
        new_h = stack_trees([o[0] for o in outs_h])
        oh = stack_trees([o[1] for o in outs_h])
        # ---- 6. context arrays --------------------------------------------
        metrics = {
            "loss_e": torch.stack([o[2]["loss"] for o in outs_e]).mean(),
            "loss_h": torch.stack([o[2]["loss"] for o in outs_h]).mean(),
            "mean_score": torch.where(mask, scores, 0.0).sum()
            / mask.sum().clamp_min(1),
        }
        return (new_e, new_h, oe, oh, update_recency(last_selected, mask,
                                                     rnd), rnd + 1, metrics)

    return fed_round_step


def make_prefill_step(cfg, seq_len: int, *, backend="chunked"):
    """(params, batch) → (logits, cache) for the dense, moe and audio
    families; logits alone for the vlm family (its prefix folds into the
    forward) and the recurrent families (a logits-only forward)."""
    if cfg.family in ("dense", "moe", "audio"):

        def prefill_step(params, batch):
            return model_mod.prefill(cfg, params, batch, max_seq=seq_len,
                                     backend=backend)

        return prefill_step

    def prefill_step(params, batch):
        return model_mod.forward(cfg, params, batch, backend=backend)[0]

    return prefill_step


def make_serve_step(cfg):
    """(params, cache, tokens (B, 1), pos) → (logits (B, 1, V), cache)."""

    def serve_step(params, cache, tokens, pos):
        return model_mod.decode_step(cfg, params, cache, tokens, pos)

    return serve_step

