"""mfu: the model FLOPs of a window's round (`counts.round_model_flops`,
the benchmark's own count from the cell's parameters; recomputation not
counted) over round_s at the card's dense bf16 peak, in %."""

from gpubench.harness import counts


def read(rec):
    if rec["model"]["family"] != "dense" or not rec.get("round_s"):
        return None
    flops = counts.round_model_flops(rec["model"], rec["cell"])
    return 100.0 * flops / (rec["round_s"] * counts.PEAK_BF16_FLOPS)
