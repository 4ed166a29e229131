"""One-card dry run — what each step should cost on one H100 (reference
`repro.launch.dryrun`, which lowers and compiles for 256 / 512 TPU v5e
chips).

For every (architecture × input shape) and each mode, the step function
runs once on `meta` tensors (shapes only: nothing is drawn, allocated or
launched on any device) under `launch.roofline.OpCounter` and
`FlopCounterMode`, and a JSON record with the roofline terms is printed
and appended to the results file:

  single  mesh "h100x1": the pair step (`launch.steps.make_train_pair_step`,
          remat) for train shapes, the prefill step (backend "flash": the
          serving route, its kernels counted by their work) for prefill
          shapes, the serve step (one token against a seq_len cache) for
          decode shapes;
  multi   mesh "h100x1-fed2": train shapes run `make_fed_round_step` over
          FED_CLIENTS stacked clients on the one card (the round the
          reference places one cohort per pod for); the serving shapes
          run as in single.

The collective fields are 0 (one card); `t_lower_s` is the trace's
seconds and `t_compile_s` 0.0 (nothing is compiled). The memory keys:
`argument_size_in_bytes` the inputs' distinct storages, `output_size_in_
bytes` the outputs', `temp_size_in_bytes` the counter's peak of storages
the step created alive at once, `generated_code_size_in_bytes` 0.
`fits_hbm` says whether arguments + temporaries fit `H100_SXM.hbm_bytes`.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  python -m repro_torch.launch.dryrun --all --out /tmp/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import FLConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.roofline import OpCounter, report_from_counter
from repro_torch.launch.specs import (batch_structs, cache_structs,
                                      param_structs)
from repro_torch.models.split import split_params
from repro_torch.optim.sgd import sgd
from repro_torch.utils.hw import H100_SXM
from repro_torch.utils.pytree import tree_leaves, tree_map

FED_CLIENTS = 2          # the reference's one PFedDST client cohort per pod
PROBE_BATCH = 8          # per-client probe batch for the s_l score
MESHES = {False: "h100x1", True: "h100x1-fed2"}


def _stack(tree, m):
    """`tree` with a leading client axis of m (each client a copy)."""
    return tree_map(lambda x: x.unsqueeze(0).expand(
        (m,) + tuple(x.shape)).clone(), tree)


def skip_reason(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "long_500k needs sub-quadratic attention (DESIGN.md §6)"
    return None


def build(cfg, shape, multi_pod: bool, *, device="meta", seed: int = 0):
    """→ (step fn, args) for one combo: meta structs by default, else real
    inputs of the same layout on `device` drawn from `seed`."""
    meta = torch.device(device).type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    opt = sgd(0.1, momentum=0.9, weight_decay=0.005)
    params = param_structs(cfg, device, gen)

    if shape.kind == "train":
        e, h = split_params(cfg, params)
        oe, oh = opt.init(e), opt.init(h)
        if not multi_pod:
            batch = batch_structs(cfg, shape.global_batch, shape.seq_len,
                                  device, gen)
            fn = steps_mod.make_train_pair_step(cfg, opt, opt, remat=True)
            return fn, (e, h, oe, oh, batch)
        m = FED_CLIENTS
        per_client = max(shape.global_batch // m, 1)
        train = _stack(batch_structs(cfg, per_client, shape.seq_len,
                                     device, gen), m)
        probe = _stack(batch_structs(cfg, PROBE_BATCH, shape.seq_len,
                                     device, gen), m)
        fl = FLConfig(num_clients=m, peers_per_round=1)
        fn = steps_mod.make_fed_round_step(cfg, fl, opt, opt, remat=True)
        args = (_stack(e, m), _stack(h, m), _stack(oe, m), _stack(oh, m),
                torch.zeros((m, m), dtype=torch.int32, device=device),
                torch.zeros((), dtype=torch.int32, device=device),
                probe, train)
        return fn, args

    if shape.kind == "prefill":
        batch = batch_structs(cfg, shape.global_batch, shape.seq_len,
                              device, gen)
        fn = steps_mod.make_prefill_step(cfg, shape.seq_len,
                                         backend="flash")
        return fn, (params, batch)

    # decode: one token at the cache's last position
    cache = cache_structs(cfg, shape.global_batch, shape.seq_len, device)
    tokens = batch_structs(cfg, shape.global_batch, 1, device,
                           gen)["tokens"]
    fn = steps_mod.make_serve_step(cfg)
    return fn, (params, cache, tokens, shape.seq_len - 1)


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under the tensors of `tree`."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def count_step(fn, args) -> dict:
    """Run `fn(*args)` once under the counters → {"counter", "xla_flops",
    "seconds", "output_bytes"}."""
    counter = OpCounter()
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops, counter:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    return dict(counter=counter, xla_flops=float(flops.get_total_flops()),
                seconds=seconds, output_bytes=storage_bytes(out))


def run_combo(arch: str, shape_name: str, multi_pod: bool, verbose=True, *,
              cfg=None, shape=None):
    """One record; `cfg` / `shape` override the registry's (a cut
    configuration, a shape outside INPUT_SHAPES)."""
    mesh_name = MESHES[multi_pod]
    chips = 1
    cfg = cfg or get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if reason:
        return {**base, "status": "skipped", "reason": reason}
    try:
        fn, args = build(cfg, shape, multi_pod)
        res = count_step(fn, args)
        counter = res["counter"]
        rep = report_from_counter(arch, shape_name, mesh_name, chips,
                                  counter, cfg, shape,
                                  xla_flops=res["xla_flops"])
        mem = {"temp_size_in_bytes": int(counter.peak_live_bytes),
               "argument_size_in_bytes": storage_bytes(args),
               "output_size_in_bytes": int(res["output_bytes"]),
               "generated_code_size_in_bytes": 0}
        if verbose:
            print(f"--- {arch} × {shape_name} × {mesh_name} ---")
            print(mem)
            print({"flops": counter.flops, "bytes accessed": counter.bytes})
        rec = {**base, "status": "ok", "t_lower_s": round(res["seconds"], 1),
               "t_compile_s": 0.0, **rep.to_dict(), **mem,
               "kernel_calls": dict(counter.kernel_calls),
               "non_meta_bytes": int(counter.non_meta_bytes),
               "fits_hbm": mem["argument_size_in_bytes"]
               + mem["temp_size_in_bytes"] <= H100_SXM.hbm_bytes}
        return rec
    except Exception as e:  # a failure here is a bug in the system
        traceback.print_exc()
        return {**base, "status": "error", "error": f"{type(e).__name__}: {e}"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh
    ]

    records = []
    for multi in meshes:
        for arch in archs:
            for shape_name in shapes:
                rec = run_combo(arch, shape_name, multi,
                                verbose=not args.quiet)
                records.append(rec)
                status = rec["status"]
                extra = rec.get("reason") or rec.get("error") or (
                    f"bottleneck={rec.get('bottleneck')} "
                    f"t=({rec.get('t_compute_s', 0):.2e},"
                    f"{rec.get('t_memory_s', 0):.2e},"
                    f"{rec.get('t_collective_s', 0):.2e})s"
                )
                print(f"[{status:7s}] {arch:25s} {shape_name:12s} "
                      f"{rec['mesh']:11s} {extra}", flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")

    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
