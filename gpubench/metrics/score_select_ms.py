"""score_select_ms: Eq. 6 probes, Eq. 7-9 scoring and top-k selection per
round, from the fenced stage timers."""

from gpubench.harness.program import STAGES


def read(rec):
    if not set(STAGES["score_select"]) & set(rec.get("stages_seen", ())):
        return None
    return rec["stage_sums"]["score_select"]
