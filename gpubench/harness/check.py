"""The comparison that decides `correct`: the program's readings of the
followed rounds against the reference's, as numbers each held to a limit
of the cell's.

Readings (either side): per round the loss metrics, the Eq. 6 loss array
and the selection mask; each round-0 participant's first phase-e step
(its loss, and the norm of every extractor leaf's momentum after it,
which is the first gradient as SGD gets it); the momentum norm of every
(partition, client, leaf) after round 0; the change norm of every
(client, leaf) after the last followed round. The reference adds its
own Eq. 9 scores and its momentum norms after the last round.

Numbers:
  loss_gap    largest |program - reference| / |reference| of a round's
              loss metric
  s_l0_gap    largest relative gap of an Eq. 6 entry of a sampled row in
              round 0, from the initial parameters (forward only)
  s_l_gap     the same over all the followed rounds
  select0_gap widest gap by which a peer the program selected in round 0
              scores below the reference's k-th best in its row (inf
              where a row selects another number of peers); round 0's
              scores come from the initial parameters alone
  select_gap  the same over all the followed rounds
  first_loss_gap
              largest relative gap of a participant's first phase-e loss
  first_mom_gap, first_mom_median
              worst and median leaf of the first step's momentum, each
              gap of norms against the larger of the reference's norm
              and the median one
  mom_gap     worst leaf: |‖m_prog‖ - ‖m_ref‖| / max(‖m_ref‖, median),
              after round 0
  mom_median  the median leaf's gap, the same way
  delta_gap, delta_median
              the same for the parameters' change
  unmoved     leaves one side moved and the other left where they were
              (momentum after round 0, change after the followed rounds;
              a client that never trained must stay unmoved)
A cell compares the numbers its `limits` name.
Leaves whose reference momentum is under a thousandth of the median
leaf's (a gradient that is nought but for rounding, as a key bias's
under softmax) are left out.
"""
from __future__ import annotations

import math
import statistics

RULE = 1e-3


def _leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """{key: gap of norms} over the `keep` keys, each against the larger
    of its reference norm and the median one."""
    considered = [k for k in ref if keep(k)]
    moved = [ref[k] for k in considered if ref[k] > 0]
    if not moved:
        return {}
    median = statistics.median(moved)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median)
            for k in considered}


def _worst_and_median(gaps: dict) -> tuple:
    if not gaps:
        return 0.0, 0.0, None
    where = max(gaps, key=gaps.get)
    return gaps[where], statistics.median(gaps.values()), where


def _one_sided(prog: dict, ref: dict, keys) -> int:
    """Keys one side moved (a nonzero norm) and the other left at 0."""
    return sum((prog[k] == 0) != (ref[k] == 0) for k in keys)


def _rule(ref_mom: dict):
    """The leaves that count: keys whose momentum reaches a thousandth of
    the median nonzero one."""
    nonzero = [v for v in ref_mom.values() if v > 0]
    floor = RULE * statistics.median(nonzero) if nonzero else 0.0
    return {k for k, v in ref_mom.items() if v >= floor and v > 0}


def gaps(prog: dict, ref: dict, cell: dict, worst: dict | None = None) -> dict:
    """The numbers compared; `worst`, if given, gets the leaf that set
    each norm gap with both sides' norms."""
    out = {"loss_gap": 0.0}
    for p_r, r_r in zip(prog["rounds"], ref["rounds"]):
        for name, r in r_r["losses"].items():
            p = p_r["losses"][name]
            gap = abs(p - r) / max(abs(r), 1e-12)
            out["loss_gap"] = max(out["loss_gap"],
                                  gap if math.isfinite(p) else math.inf)
    k = min(cell["fl"]["peers_per_round"], cell["fl"]["num_clients"] - 1)
    s_l, sel = [], []
    for p_r, r_r in zip(prog["rounds"], ref["rounds"]):
        rows = r_r["active"].nonzero().flatten()
        lp, lr = p_r["loss_matrix"][rows], r_r["loss_matrix"][rows]
        s_l.append(float(((lp - lr).abs()
                          / lr.abs().clamp_min(1e-12)).max()))
        sel.append(_select_gap(p_r["mask"], r_r["scores"], r_r["active"], k))
    out.update(s_l0_gap=s_l[0], s_l_gap=max(s_l), select0_gap=sel[0],
               select_gap=max(sel))
    p_f, r_f = prog["first"], ref["first"]
    out["first_loss_gap"] = max(
        (abs(p_f["loss"][c] - r) / max(abs(r), 1e-12)
         if math.isfinite(p_f["loss"][c]) else math.inf)
        for c, r in r_f["loss"].items())
    kept = _rule(r_f["mom"])
    out["first_mom_gap"], out["first_mom_median"], k_first = \
        _worst_and_median(_leaf_gaps(p_f["mom"], r_f["mom"],
                                     lambda key: key in kept))
    first = _rule(ref["mom0"])
    out["mom_gap"], out["mom_median"], k_mom = _worst_and_median(
        _leaf_gaps(prog["mom0"], ref["mom0"], lambda key: key in first))
    counted = {(c, n) for (_, c, n) in _rule(ref["mom_end"])}
    out["delta_gap"], out["delta_median"], k_delta = _worst_and_median(
        _leaf_gaps(prog["delta"], ref["delta"], lambda key: key in counted))
    never = {(c, n) for (_, c, n), v in ref["mom_end"].items() if v == 0}
    out["unmoved"] = float(_one_sided(prog["mom0"], ref["mom0"], first)
                           + _one_sided(prog["delta"], ref["delta"],
                                        counted | never))
    if worst is not None:
        for name, key, p, r in (("first_mom_gap", k_first, p_f["mom"],
                                 r_f["mom"]),
                                ("mom_gap", k_mom, prog["mom0"], ref["mom0"]),
                                ("delta_gap", k_delta, prog["delta"],
                                 ref["delta"])):
            if key is not None:
                worst[name] = {"leaf": list(key), "program": p[key],
                               "reference": r[key]}
    return out


def _select_gap(mask, scores, active, k: int) -> float:
    worst = 0.0
    for i in range(mask.shape[0]):
        picked = mask[i].nonzero().flatten()
        want = k if bool(active[i]) else 0
        if len(picked) != want:
            return math.inf
        if want == 0:
            continue
        kth = scores[i].sort(descending=True).values[k - 1]
        worst = max(worst, float((kth - scores[i][picked]).max()))
    return max(worst, 0.0)


def decide(numbers: dict, limits: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}) over the numbers the cell
    gives a limit; one that is not finite fails."""
    table = {n: {"value": numbers[n], "limit": lim}
             for n, lim in limits.items()}
    ok = all(math.isfinite(row["value"]) and row["value"] <= row["limit"]
             for row in table.values())
    return ok, table
