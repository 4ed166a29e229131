#!/usr/bin/env python3
"""The readings a cell's limits are set from, at the cell's own size, on
the card, several seeds in one process (the benchmark's runs do not run
this):

    python3 gpubench/readings.py --workload <cell> --seeds 1 2 3 \\
        --variants program control half_batch bottom_k [--rounds 1]

For each seed, each variant in the program's place is compared with the
float32 reference exactly as a run compares the program:
  program     the port, as a run drives it (set-up's followed rounds);
  control     the reference computed in fp8 (both operands of every
              product rounded to e4m3): the precision below the bf16 the
              configurations state;
  half_batch, half_clients, no_mix, altered, bottom_k
              the reference with a fault planted: half of every SGD
              step's batch left out, or half of the round's sampled
              clients left out of training (the mean over the rest), the
              extractor's aggregation left out, one answer altered where
              it is produced (one Eq. 6 row summed over its probe rows,
              not averaged), or each row's k lowest-scoring peers
              selected.
A state left unchanged reads 1 on delta_gap by construction.
--rounds cuts the followed rounds (the numbers of round 0 and of the
first step read the same with one). One JSON line per (seed, variant) on
standard output.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gpubench import run  # noqa: E402

VARIANTS = ("program", "control", "half_batch", "half_clients", "no_mix",
            "altered", "bottom_k")


def plain(readings: dict) -> dict:
    """A side's readings as JSON: tensors as lists, norm keys joined."""
    out = {"rounds": [{k: (v.tolist() if hasattr(v, "tolist") else v)
                       for k, v in r.items()} for r in readings["rounds"]]}
    for key in ("mom0", "delta", "mom_end"):
        if key in readings:
            out[key] = {"|".join(map(str, k)): v
                        for k, v in readings[key].items()}
    out["first"] = {part: {"|".join(map(str, k if isinstance(k, tuple)
                                        else (k,))): v
                           for k, v in values.items()}
                    for part, values in readings["first"].items()}
    return out


def same_masks(a: dict, b: dict) -> bool:
    return all(bool((x["mask"] == y["mask"]).all())
               for x, y in zip(a["rounds"], b["rounds"]))


def readings(cell: dict, model: dict, seed: int, variants, device,
             program=None, dump=None) -> list:
    """[(variant, gaps, seconds, worst leaves)] of one seed."""
    import torch

    from gpubench.harness import check
    from gpubench.harness.program import Port

    inp = run.Inputs(cell, model, seed, device)
    out = []
    own = None
    for variant in variants:
        t0 = time.perf_counter()
        if variant == "program":
            port = (program or Port)(cell, model, device)
            state, prog, _ = run.follow_program(port, inp)
            del state, port
        else:
            prog = run.reference_readings(
                inp, None, precision="fp8" if variant == "control"
                else "float32", fault=None if variant == "control"
                else variant)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if own is None:
            own = run.reference_readings(inp, None)
        ref = own if same_masks(prog, own) else \
            run.reference_readings(inp, prog)
        if dump is not None:
            dump[variant] = {side: plain(d) for side, d in
                             (("program", prog), ("reference", ref))}
        worst = {}
        out.append((variant, check.gaps(prog, ref, cell, worst),
                    time.perf_counter() - t0, worst))
        del prog, ref
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="limit readings of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--rounds", type=int, default=None,
                    help="follow this many rounds instead of the cell's")
    ap.add_argument("--dump", default=None,
                    help="write every leaf's norms, both sides, to this "
                         "JSON file")
    args = ap.parse_args(argv)
    from gpubench.harness import spec

    cell = spec.cell(args.workload)
    model = spec.config(cell["config"])
    if args.rounds is not None:
        cell["reference"]["rounds"] = args.rounds
    os.environ["TRITON_CACHE_DIR"] = str(run.ROOT / ".gpubench_cache"
                                         / "triton")
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(run.ROOT / "src"))
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        dump = {} if args.dump else None
        for variant, gaps, secs, worst in readings(cell, model, seed,
                                                   args.variants, device,
                                                   dump=dump):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": variant, "seconds": secs,
                              "gaps": gaps, "worst": worst}), flush=True)
        if dump is not None:
            with open(f"{args.dump}.{seed}.json", "w") as f:
                json.dump(dump, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
