"""Population churn — join/leave dynamics on a fixed-capacity slot array,
reference `repro.openworld.lifecycle`.

An open population is M slots plus an `alive` membership mask: `leave`
marks a slot dead (its parameters stay in place), `join` revives a dead
slot as a NEWCOMER. The churn stage runs first in a wrapped strategy
(`compose.make_open_spec`), so every later stage sees membership through
the round context:

    ctx.alive    the post-churn (M,) mask
    ctx.active   intersected with it — dead clients never train
    ctx.cand     intersected with alive⊗alive — dead peers are
                 unreachable (not selectable, scoreable or mixed)

A newcomer pulls the mean of the parameters the pre-churn alive peers
SERVE (the versioned peer store's served view for pfeddst_async, live
parameters otherwise) and resets the rest of its row: optimizer state to
zeros (bitwise `optim.sgd` init), its Eq. 6 loss row to 0 and its recency
row to −1. DisPFL's masks persist with the slot.

Zero-alive guard: a draw that would empty the population is rolled back
for the round, `where(any(new_alive), new_alive, alive)` on the device
(no host sync).

Randomness: the leave and join uniforms come from CPU generators keyed
by the round key and `CHURN_SALT` (`fl.engine.salted_streams`), apart
from every strategy stream, or from `ctx.draws["churn"]` = (u_leave,
u_join). With zero rates the Bernoulli masks are all False, every
`where` keeps its old branch and the candidate intersection is with
all-True: the closed population, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aggregation import mean_over_active
from repro_torch.core.client_state import PopulationState
from repro_torch.fl.engine import salted_streams, where_tree
from repro_torch.fl.hetero import store_serve
from repro_torch.utils.pytree import tree_map

CHURN_SALT = 0x6F77                      # 'ow', the reference's salt


# ---------------------------------------------------------------------------
# state accessors — every strategy state is a PopulationState (pfeddst*)
# or a dict with a "params" entry (the baselines)
# ---------------------------------------------------------------------------

def population_params(inner):
    """The peer-visible parameter view of a strategy state: what a
    byzantine adversary corrupts and a newcomer bootstraps from."""
    if isinstance(inner, PopulationState):
        return {"e": inner.extractor, "h": inner.header}
    return inner["params"]


def with_population_params(inner, tree):
    """Inverse of `population_params`: write the view back."""
    if isinstance(inner, PopulationState):
        return inner._replace(extractor=tree["e"], header=tree["h"])
    return {**inner, "params": tree}


def serving_params(inner, ctx):
    """What peers would PULL this round: the peer store's served
    snapshots (`fl.hetero.store_serve` at the host int round, under the
    round's channel lag) for a versioned strategy, live parameters
    otherwise; the tree of `population_params`."""
    if isinstance(inner, PopulationState) and inner.store is not None:
        served, _ = store_serve(inner.store, int(inner.round), ctx.stale)
        return served
    return population_params(inner)


def _mean_over_active(tree, active):
    """`mean_over_active` over a dict of tensors or of such dicts."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return mean_over_active(tree, active)
    return {k: _mean_over_active(v, active) for k, v in tree.items()}


def reset_joined_rows(inner, joined):
    """A newcomer's non-parameter rows to their init values: optimizer
    accumulators to zeros (== `optim.sgd` init), the Eq. 6 loss row to 0,
    the recency row to −1. Rows outside `joined` are untouched."""

    def zeros(tree):
        return tree_map(torch.zeros_like, tree)

    if isinstance(inner, PopulationState):
        return inner._replace(
            opt_e=where_tree(joined, zeros(inner.opt_e), inner.opt_e),
            opt_h=where_tree(joined, zeros(inner.opt_h), inner.opt_h),
            loss_matrix=torch.where(joined[:, None], 0.0,
                                    inner.loss_matrix),
            last_selected=torch.where(joined[:, None], -1,
                                      inner.last_selected).to(
                inner.last_selected.dtype))
    out = dict(inner)
    if "opt" in out:
        out["opt"] = where_tree(joined, zeros(out["opt"]), out["opt"])
    return out


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def init_alive(m: int, churn) -> np.ndarray:
    """Initial (M,) membership: the first max(1, round(init_alive·M))
    slots start alive (a deterministic prefix)."""
    if churn is None:
        return np.ones((m,), dtype=bool)
    frac = min(max(float(churn.init_alive), 0.0), 1.0)
    k = max(1, int(round(m * frac))) if m > 0 else 0
    alive = np.zeros((m,), dtype=bool)
    alive[:k] = True
    return alive


def churn_uniforms(ctx):
    """(u_leave, u_join), each (M,) f32 on the round's device:
    `ctx.draws["churn"]`, else drawn from the round's CHURN_SALT
    generators."""
    u = ctx.draw("churn")
    if u is None:
        gens = salted_streams(ctx.key, CHURN_SALT, ("leave", "join"))
        u = (torch.rand(ctx.m, generator=gens["leave"]),
             torch.rand(ctx.m, generator=gens["join"]))
    # one (2, M) copy to the device
    both = torch.stack([x.float().cpu() if isinstance(x, torch.Tensor)
                        else torch.from_numpy(np.array(x, np.float32))
                        for x in u])
    return tuple(both.to(ctx.active.device).unbind(0))


def stage_churn(churn):
    """The membership stage — the first stage of an open population, over
    the wrapper state `{"inner": strategy state, "alive": (M,)}`: iid
    Bernoulli(leave_rate) departures among the alive, Bernoulli(join_rate)
    arrivals among the dead (zero-alive guard), newcomer bootstrap and
    row resets, the intersections into ctx.active / ctx.cand, and the
    alive_frac / joined_n / left_n telemetry."""

    def ow_churn(state, ctx):
        alive, inner = state["alive"], state["inner"]
        u_leave, u_join = churn_uniforms(ctx)
        leave = (u_leave < churn.leave_rate) & alive
        join = (u_join < churn.join_rate) & ~alive
        new_alive = (alive & ~leave) | join
        new_alive = torch.where(new_alive.any(), new_alive, alive)
        joined = new_alive & ~alive
        left = alive & ~new_alive

        # newcomers bootstrap from the PRE-churn alive peers' served view
        boot = _mean_over_active(serving_params(inner, ctx), alive)
        inner = with_population_params(
            inner, where_tree(joined, boot, population_params(inner)))
        inner = reset_joined_rows(inner, joined)

        ctx.alive = new_alive
        ctx.active = ctx.active & new_alive
        pair = new_alive[:, None] & new_alive[None, :]
        if ctx.cand is None:
            ctx.cand = pair & ~torch.eye(ctx.m, dtype=torch.bool,
                                         device=pair.device)
        else:
            ctx.cand = ctx.cand & pair
        ctx.record("alive_frac", new_alive.float().mean())
        ctx.record("joined_n", joined.sum().to(torch.int32))
        ctx.record("left_n", left.sum().to(torch.int32))
        return {**state, "inner": inner, "alive": new_alive}

    return ow_churn
