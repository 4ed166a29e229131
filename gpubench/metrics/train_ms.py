"""train_ms: local training's wall per round, from the fenced stage
timers (`obs/timers.instrument_stages`): phase_e + phase_h."""

from gpubench.harness.program import STAGES


def read(rec):
    if not set(STAGES["train"]) & set(rec.get("stages_seen", ())):
        return None
    return rec["stage_sums"]["train"]
