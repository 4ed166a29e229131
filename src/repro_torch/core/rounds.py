"""PFedDST Algorithm 1 — one synchronous communication round over the
population, reference `repro.core.rounds`.

Round structure (per active client i):
  1. score every peer:      S_ij = s_p·(α·s_l − s_d + c)      (Eq. 6–9)
  2. select peers M_i       (top-k, threshold or random)
  3. aggregate extractors   e_i ← avg{e_j : j ∈ M_i ∪ {i}}
  4. phase-e training       K_e epochs, header frozen          (Eq. 3)
  5. phase-h training       K_h epochs, extractor frozen       (Eq. 4)
  6. update context arrays  (loss array l, recency array t)

Eq. 6 probes run only for the sampled rows; inactive rows keep their
cached `loss_matrix` entries. Training runs only the sampled rows, one
client at a time, and scatters them back.

The comms fabric reaches the round through the engine's context: the
candidate mask `ctx.cand` restricts every selection mode (and the fused
`select_topk` kernel), the Eq. 9 cost is `ctx.cost` (else the scalar
`fl.comm_cost`), and a packed fabric's neighbour view `ctx.nbr` routes
the top-k scoring through `score_topk_sparse`.

The open world (`repro_torch.openworld`) reaches it the same way: a
threat cast in `ctx.threat` with a score game spoofs the header view and
the cost matrix before both the fused and the dense branch (a threatened
round on a packed fabric takes the dense branches), and
`ThreatConfig.defense` replaces the extractor mix of `aggregate` with
`robust_row_aggregate` over the selected peer set (over the served
extractors under `hetero`).

Passing a `fl.hetero.HeteroRuntime` (the `pfeddst_async` strategy) wraps
the same stages with the deadline gate, serving from the versioned peer
store and staleness-weighted aggregation, and a publish stage:
(gate, score_select, aggregate, phase_e, phase_h, publish,
update_context).
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregation import (
    aggregate_extractors,
    selection_to_weights,
    staleness_weights,
)
from repro_torch.core.client_state import PopulationState
from repro_torch.core.partial_freeze import PhaseSteps
from repro_torch.core.scoring import (
    flatten_headers,
    header_distance_matrix,
    loss_disparity_rows,
    recency_scores,
    score_topk,
    score_topk_sparse,
    selected_components,
)
from repro_torch.core.selection import (
    NEG,
    as_cost_matrix,
    combined_scores,
    select_peers,
    topk_to_mask,
    update_recency,
)
from repro_torch.data.pipeline import sample_client_batches
from repro_torch.fl.engine import (
    ExchangePlan,
    RoundContext,
    run_round,
    train_rows,
    trains_in_place,
    where_rows_,
    where_tree,
)
from repro_torch.fl.hetero import (
    pull_staleness,
    stage_deadline_gate,
    store_publish,
    store_serve,
)
from repro_torch.models.split import merge_params
from repro_torch.openworld.defense import robust_row_aggregate

# stream layout of one PFedDST round (the reference's PFEDDST_STREAMS)
PFEDDST_STREAMS = ("probe", "act", "e", "h", "rand")


def make_pfeddst_stages(cfg, fl, steps: PhaseSteps, *,
                        steps_per_epoch: int = 1, probe_size: int = 64,
                        use_score_kernel: bool = False, hetero=None):
    """Algorithm 1 as engine stages over a PopulationState.

    use_score_kernel: route Eq. 7–9 scoring + top-k through the fused
    `select_topk` kernel (topk selection), or the Eq. 7 Gram through the
    `raw_gram` kernel (threshold and random selection, which keep the
    dense chain).

    hetero: optional `fl.hetero.HeteroRuntime`, the semi-async variant.
    It prepends the deadline gate, scores and aggregates against the
    peer store's served snapshots (Eq. 7 sees the header a peer actually
    publishes; the pull lag is discounted by `(1 + lag)^(−α)`), and
    appends the publish stage. The Eq. 6 rows evaluate the row client's
    own (always fresh) model and do not version. With a uniform profile
    and an infinite deadline every hetero operation is an identity."""
    defense = fl.threat.defense if fl.threat is not None else "none"
    in_place = trains_in_place(cfg)

    def score_select(state: PopulationState, ctx: RoundContext):
        # ---- 1. scoring — Eq. 6 restricted to the sampled rows ------------
        m = ctx.m
        probe = sample_client_batches(ctx.streams["probe"], ctx.data,
                                      probe_size, idx=ctx.draw("probe"))
        params = merge_params(state.extractor, state.header)
        s_l_rows = loss_disparity_rows(cfg, params, probe,
                                       rows=ctx.sampled_rows())  # (n, M)
        s_l = state.loss_matrix.clone()
        s_l[ctx.sampled_idx] = s_l_rows
        header_view = state.header
        if hetero is not None:
            # absent peers serve their published snapshot (a channel lag
            # picks an older slot); this round's participants exchange in
            # real time, so their columns (each client's own diagonal
            # included) are their live state, of age 0. Their deadline
            # misses still discount them through store.lag.
            ctx.store = state.store
            served, age = store_serve(state.store, int(state.round),
                                      ctx.stale)
            served = {"e": where_tree(ctx.active, state.extractor,
                                      served["e"]),
                      "h": where_tree(ctx.active, state.header,
                                      served["h"])}
            age = torch.where(ctx.active, 0, age)
            lag = pull_staleness(state.store, ctx.stale, hetero.depth,
                                 active=ctx.active)
            ctx.aux.update(served=served, serve_age=age, pull_lag=lag)
            header_view = served["h"]
        cost = fl.comm_cost if ctx.cost is None else ctx.cost
        flat = flatten_headers(header_view)
        if ctx.threat is not None and ctx.threat.score_game != "none":
            # score-integrity adversaries spoof the header and cost view
            # the scorer sees (both branches below read them)
            flat, cost = ctx.threat.game_scores(flat, cost, m)
        k = min(fl.peers_per_round, m - 1)
        fused = (use_score_kernel and m > 1 and fl.peers_per_round > 0
                 and fl.selection not in ("threshold", "random"))
        # a packed fabric's neighbour view: top-k over each row's D
        # neighbours, O(M·D·P), whatever use_score_kernel says
        # a threatened round spoofs dense costs: it takes the dense branches
        packed = (ctx.nbr is not None and m > 1 and fl.peers_per_round > 0
                  and fl.selection not in ("threshold", "random")
                  and ctx.threat is None)
        fused = fused or packed   # both feed the metrics a top-k channel
        if fused:
            # ---- 1b/2. Eq. 7–9 + top-k: packed, or the fused kernel --------
            if packed:
                vals, idx, sd_stats = score_topk_sparse(
                    flat, state.last_selected, s_l, state.round,
                    nbr_idx=ctx.nbr["idx"], nbr_valid=ctx.nbr["valid"],
                    alpha=fl.alpha, lam=fl.recency_lambda,
                    comm_cost=ctx.nbr["cost"], k=k)
            else:
                vals, idx, sd_stats = score_topk(
                    flat, state.last_selected, s_l, state.round,
                    alpha=fl.alpha, lam=fl.recency_lambda, comm_cost=cost,
                    k=k, candidate_mask=ctx.cand)
            mask = topk_to_mask(idx, vals, m)
            ctx.aux.update(s_l=s_l, s_l_rows=s_l_rows, topk_vals=vals,
                           topk_idx=idx, sd_stats=sd_stats)
        else:
            s_d = header_distance_matrix(flat, use_kernel=use_score_kernel)
            s_p = recency_scores(state.last_selected, state.round,
                                 fl.recency_lambda)
            scores = combined_scores(s_l, s_d, s_p, alpha=fl.alpha,
                                     comm_cost=cost)
            # ---- 2. selection --------------------------------------------
            if fl.selection == "threshold":
                mask = select_peers(scores, threshold=fl.score_threshold,
                                    candidate_mask=ctx.cand)
            elif fl.selection == "random":
                rand = ctx.uniform("rand", (m, m), flat.device)
                eye = torch.eye(m, dtype=torch.bool, device=flat.device)
                mask = select_peers(torch.where(eye, -1.0, rand),
                                    k=fl.peers_per_round,
                                    candidate_mask=ctx.cand)
            else:
                mask = select_peers(scores, k=fl.peers_per_round,
                                    candidate_mask=ctx.cand)
            ctx.aux.update(s_l=s_l, s_l_rows=s_l_rows, s_d=s_d,
                           scores=scores)
        mask = mask & ctx.active[:, None]

        # ---- Eq. 9 score decomposition over the selected edges ------------
        n_sel = mask.sum().clamp_min(1).float()
        if fused:
            comp = selected_components(
                flat, state.last_selected, s_l, state.round,
                ctx.aux["topk_idx"], alpha=fl.alpha, lam=fl.recency_lambda,
                comm_cost=cost)
            valid = (ctx.aux["topk_vals"] > NEG / 2) & ctx.active[:, None]
            for name in ("s_l", "s_d", "s_p", "cost"):
                ctx.record(f"sel_{name}_mean",
                           torch.where(valid, comp[name], 0.0).sum() / n_sel)
        else:
            for name, mat in (("s_l", s_l), ("s_d", s_d), ("s_p", s_p),
                              ("cost", as_cost_matrix(cost, m,
                                                      flat.device))):
                ctx.record(f"sel_{name}_mean",
                           torch.where(mask, mat, 0.0).sum() / n_sel)

        if hetero is not None:
            lag = ctx.aux["pull_lag"]
            weights = staleness_weights(mask, lag, alpha=hetero.alpha)
            n_edges = mask.sum().clamp_min(1)
            ctx.metrics["eff_lag_mean"] = torch.where(
                mask, lag[None, :].float(), 0.0).sum() / n_edges
            ctx.metrics["eff_lag_max"] = torch.where(
                mask, lag[None, :], 0).max()
            ctx.metrics["serve_age_mean"] = torch.where(
                mask, ctx.aux["serve_age"][None, :].float(),
                0.0).sum() / n_edges
        else:
            weights = selection_to_weights(mask, include_self=True)
        ctx.plan = ExchangePlan("p2p", active=ctx.active, edges=mask,
                                weights=weights)
        return state

    def aggregate(state: PopulationState, ctx: RoundContext):
        # ---- 3. aggregate extractors --------------------------------------
        src_e = (ctx.aux["served"]["e"] if hetero is not None
                 else state.extractor)
        if defense != "none":
            # robust aggregation over the selected peer set; norm_clip
            # keeps the plan's weights (staleness discounts included), the
            # order statistics aggregate the set uniformly
            agg_e = robust_row_aggregate(
                src_e, ctx.plan.edges, ctx.plan.weights, ctx.m,
                defense=defense, trim=fl.threat.trim_fraction,
                clip=fl.threat.clip_factor)
        else:
            agg_e = aggregate_extractors(src_e, ctx.plan.weights)
        ctx.aux["agg_e"] = where_rows_(ctx.active, agg_e, state.extractor)
        return state

    def _sampled_mean(last, ctx):
        """The last step's losses of the sampled rows (n,), averaged over
        the active clients."""
        loss_full = torch.zeros(ctx.m, device=last.device)
        loss_full[ctx.sampled_idx] = last
        return ((loss_full * ctx.active).sum()
                / ctx.active.sum().clamp_min(1))

    def phase_e(state: PopulationState, ctx: RoundContext):
        # ---- 4. phase-e (header frozen) -----------------------------------
        # the aggregated extractor (inactive rows hold their own) is
        # trained on the active rows and becomes the extractor
        new_e, opt_e, loss_e = train_rows(
            ctx, steps.phase_e, ctx.aux.pop("agg_e"), state.header,
            state.opt_e, "e", fl.epochs_extractor * steps_per_epoch,
            fl.batch_size, in_place=in_place)
        ctx.metrics["train_loss_e"] = _sampled_mean(loss_e[-1], ctx)
        return state._replace(extractor=new_e, opt_e=opt_e)

    def phase_h(state: PopulationState, ctx: RoundContext):
        # ---- 5. phase-h (extractor frozen) --------------------------------
        new_h, opt_h, loss_h = train_rows(
            ctx, lambda h, e, o, b, **kw: steps.phase_h(e, h, o, b, **kw),
            state.header, state.extractor, state.opt_h, "h",
            fl.epochs_header * steps_per_epoch, fl.batch_size,
            in_place=in_place)
        ctx.metrics["train_loss_h"] = _sampled_mean(loss_h[-1], ctx)
        return state._replace(header=new_h, opt_h=opt_h)

    def update_context(state: PopulationState, ctx: RoundContext):
        # ---- 6. context arrays --------------------------------------------
        m = ctx.m
        mask = ctx.plan.edges
        loss_matrix = torch.where(ctx.active[:, None], ctx.aux["s_l"],
                                  state.loss_matrix)
        if "scores" in ctx.aux:
            scores, s_d = ctx.aux["scores"], ctx.aux["s_d"]
            sel_sum = torch.where(mask, scores, 0.0).sum()
            sd_sum, sd_trace = s_d.sum(), torch.trace(s_d)
        else:
            # fused: the selected scores are the emitted top-k values and
            # the s_d sums come from the kernel's row statistics
            vals = ctx.aux["topk_vals"]
            sel = (vals > NEG / 2) & ctx.active[:, None]
            sel_sum = torch.where(sel, vals, 0.0).sum()
            sd_sum = ctx.aux["sd_stats"][:, 0].sum()
            sd_trace = ctx.aux["sd_stats"][:, 1].sum()
        ctx.metrics.update(
            mean_selected_score=sel_sum / mask.sum().clamp_min(1),
            s_l_mean=ctx.aux["s_l_rows"].mean(),
            s_d_offdiag_mean=(sd_sum - sd_trace) / (m * (m - 1)),
            select_mask=mask,
        )
        return state._replace(
            loss_matrix=loss_matrix,
            last_selected=update_recency(state.last_selected, mask,
                                         state.round),
            round=state.round + 1,
        )

    if hetero is None:
        return (score_select, aggregate, phase_e, phase_h, update_context)

    def publish(state: PopulationState, ctx: RoundContext):
        # ---- 5.5 publish: the completers' snapshots enter the ring --------
        # (in place: this round consumes its input state's store)
        store = store_publish(state.store,
                              {"e": state.extractor, "h": state.header},
                              ctx.active, ctx.aux["deadline_blocked"],
                              int(state.round))
        return state._replace(store=store)

    gate = stage_deadline_gate(hetero, get_round=lambda s: s.round)
    return (gate, score_select, aggregate, phase_e, phase_h, publish,
            update_context)


def pfeddst_round(cfg, fl, steps: PhaseSteps, state: PopulationState,
                  train_data: dict, key, *, steps_per_epoch: int = 1,
                  probe_size: int = 64, use_score_kernel: bool = False,
                  draws: dict | None = None):
    """One communication round. train_data: dict of (M, N, ...) tensors;
    key: the round key (tuple of ints); draws: optional injected draws
    (see fl.engine). → (new_state, metrics dict)."""
    stages = make_pfeddst_stages(cfg, fl, steps,
                                 steps_per_epoch=steps_per_epoch,
                                 probe_size=probe_size,
                                 use_score_kernel=use_score_kernel)
    return run_round(stages, state, train_data, key,
                     m=state.loss_matrix.shape[0],
                     ratio=fl.client_sample_ratio,
                     key_streams=PFEDDST_STREAMS, draws=draws)
