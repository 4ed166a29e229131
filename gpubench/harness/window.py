"""The timed window: whole rounds back to back in a closed loop, fenced
only at its start and end, until `seconds` have passed."""
from __future__ import annotations

import time


def run_window(one_round, seconds: float, *, sync=lambda: None,
               clock=time.perf_counter) -> dict:
    """Call `one_round(i)` for i = 0, 1, ... until the window has lasted
    `seconds` at the end of a round. -> rounds, wall_s, round_s (the
    wall over the rounds) and round_walls (each round's, by the host's
    clock at its end: a diagnostic, not a metric)."""
    sync()
    t0 = clock()
    ends = []
    while True:
        one_round(len(ends))
        ends.append(clock() - t0)
        if ends[-1] >= seconds:
            break
    sync()
    wall = clock() - t0
    return {"rounds": len(ends), "wall_s": wall, "round_s": wall / len(ends),
            "round_walls": [b - a for a, b in zip([0.0] + ends, ends)]}
