"""repro_torch.openworld — population churn, byzantine peers and
score-integrity adversaries composable onto any strategy; the port of
`repro.openworld`.

Entry point: `make_open_spec(spec, fl)` (compose), applied to every
`StrategySpec` by `fl.strategies.make_spec`. Submodules: lifecycle
(join/leave churn + newcomer bootstrap), attacks (byzantine update
corruption + Eq. 7/9 score gaming), defense (robust reducers and mixers
for the engine's hooks), metrics (attacker isolation). Configured through
`configs.base.ThreatConfig` / `ChurnConfig` on FLConfig.
"""
from repro_torch.openworld.attacks import (
    ATTACKS,
    SCORE_GAMES,
    ThreatState,
    adversary_mask,
)
from repro_torch.openworld.compose import make_open_spec, threat_state
from repro_torch.openworld.defense import (
    DEFENSES,
    median_over_active,
    norm_clip_mean_over_active,
    robust_mixer,
    robust_row_aggregate,
    star_reducer,
    trimmed_mean_over_active,
)
from repro_torch.openworld.lifecycle import init_alive, stage_churn
from repro_torch.openworld.metrics import isolation_metrics

__all__ = [
    "ATTACKS",
    "DEFENSES",
    "SCORE_GAMES",
    "ThreatState",
    "adversary_mask",
    "init_alive",
    "isolation_metrics",
    "make_open_spec",
    "median_over_active",
    "norm_clip_mean_over_active",
    "robust_mixer",
    "robust_row_aggregate",
    "stage_churn",
    "star_reducer",
    "threat_state",
    "trimmed_mean_over_active",
]
