"""aggregate_ms: the extractor's aggregation per round (the selected-peer
average), from the fenced stage timers."""

from gpubench.harness.program import STAGES


def read(rec):
    if not set(STAGES["aggregate"]) & set(rec.get("stages_seen", ())):
        return None
    return rec["stage_sums"]["aggregate"]
