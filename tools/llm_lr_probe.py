#!/usr/bin/env python3
"""Do the full-model baselines' losses over qwen2-1.5b rise because of
the learning rate?

Runs the port's `run_experiment` for dfedpgp (k = 1) and dispfl over
qwen2-1.5b at full width and all 28 layers in bf16 on one CUDA card, at
chip_smoke.py phase 12's settings (M = 4, batch 8 × 64 tokens, sample
ratio 1.0, `synth_tokens` over 2 domains, eval every round), for 3
rounds at phase 12's lr 0.05 and at 0.005, and prints each round's
train_loss and accuracy. The uniform guess's loss, ln(vocab), is
printed beside them. Each round trains the whole model for 5 SGD steps
(momentum 0.9) a client, as every full-model baseline does. The card's
name and power limit come first; the rows also go to
chiprun_out/llm_lr_probe.json.

    python3 tools/llm_lr_probe.py
"""
from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ROUNDS = 3
LRS = (0.05, 0.005)
RUNS = (("dfedpgp", {"peers_per_round": 1}), ("dispfl", {}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("llm_lr_probe: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.fl.simulator import run_experiment

    print(smoke.card_line(), flush=True)
    cfg = get_config(smoke.LLM_ARCH)
    data = smoke.llm_data(cfg)
    print(f"uniform guess: ln({cfg.vocab_size}) = "
          f"{math.log(cfg.vocab_size):.4f}", flush=True)
    rows = []
    for name, changes in RUNS:
        for lr in LRS:
            fl = FLConfig(**{**smoke.LLM_FL, **changes, "lr": lr})
            t0 = time.perf_counter()
            hist = run_experiment(name, cfg, fl, data, num_rounds=ROUNDS,
                                  eval_every=1, steps_per_epoch=1, seed=0,
                                  verbose=False, device="cuda").to_dict()
            row = dict(name=name, lr=lr, peers=fl.peers_per_round,
                       train_loss=hist["train_loss"],
                       accuracy=hist["accuracy"],
                       run_s=time.perf_counter() - t0)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del hist
            torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "llm_lr_probe.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
