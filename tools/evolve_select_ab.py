#!/usr/bin/env python3
"""A/B of the port's mask_evolve and select_topk kernels between checkouts,
on one CUDA card.

    python3 tools/evolve_select_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout (a directory holding
`src/repro_torch`). The checkouts run one after another in the order
given, each in a process of its own that builds the checkout's kernels
with its own `kernels/build.py` and calls its own `kernels.ops`, so two
checkouts with different C interfaces compare. Each run prints one JSON
line:

* mask_evolve on the dispfl round's stacked leaves (full-width ResNet-18
  from the checkout's own `init_params`, M = 16 copies of each parameter,
  bfloat16, keep = n·(1 − dispfl_sparsity), regrow 0.02): the per-leaf
  loop of `ops.mask_evolve` over all leaves (what a round ran before
  `ops.mask_evolve_leaves`), the one call of `ops.mask_evolve_leaves`
  where the checkout has it (its outputs bitwise equal to the loop's), and
  the largest leaf alone; CUDA events over back-to-back calls.
* select_topk at M ∈ {16, 1024, 4096}, P = 5130 (the ResNet-18 header),
  k = 4, 10, 10: the time per Python call (CUDA events) and on the device
  alone (CUDA-graph replay), and its index agreement with the plain
  version.

The card's name and power limit come first.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from raw_gram_ab import graph_ms, time_ms

P = 5130
SELECT_CASES = ((16, 4, 200), (1024, 10, 20), (4096, 10, 5))  # M, k, iters


def evolve_rows(ops, dev) -> dict:
    import torch

    from repro_torch.configs import FLConfig, get_config
    from repro_torch.models import model as model_mod

    params = model_mod.init_params(get_config("resnet18-cifar"),
                                   torch.Generator(device=dev).manual_seed(0),
                                   dev)
    g = torch.Generator(device=dev).manual_seed(13)
    leaves = [(torch.randn((16, *t.shape), generator=g, device=dev) * 0.05)
              .to(torch.bfloat16) for t in params.values()]
    grows = [torch.rand(x.shape, generator=g, device=dev) > 0.98
             for x in leaves]
    frac = 1 - FLConfig().dispfl_sparsity
    keeps = [max(int(x.numel() * frac), 1) for x in leaves]

    def per_leaf():
        return [ops.mask_evolve(x, gr, keep=k)
                for x, gr, k in zip(leaves, grows, keeps)]

    big = max(range(len(leaves)), key=lambda i: leaves[i].numel())
    row = dict(leaves=len(leaves), n=sum(x.numel() for x in leaves),
               per_leaf_loop_ms=time_ms(per_leaf, 10),
               largest_leaf=list(leaves[big].shape),
               largest_leaf_ms=time_ms(lambda: ops.mask_evolve(
                   leaves[big], grows[big], keep=keeps[big]), 10))
    if hasattr(ops, "mask_evolve_leaves"):
        one = ops.mask_evolve_leaves(leaves, grows, keeps)
        loop = per_leaf()
        torch.cuda.synchronize()
        row["batched_equals_loop"] = all(
            torch.equal(a.view(torch.int16), b.view(torch.int16))
            and torch.equal(ma, mb) for (a, ma), (b, mb) in zip(one, loop))
        row["batched_ms"] = time_ms(
            lambda: ops.mask_evolve_leaves(leaves, grows, keeps), 10)
    return row


def select_rows(ops, dev) -> list:
    import torch

    rows = []
    for m, k, iters in SELECT_CASES:
        g = torch.Generator(device=dev).manual_seed(m)
        x = torch.randn((m, P), generator=g, device=dev)
        last = torch.randint(-1, 5, (m, m), generator=g, device=dev,
                             dtype=torch.int32)
        s_l = torch.rand((m, m), generator=g, device=dev) * 3.0
        kw = dict(k=k, alpha=1.0, lam=0.5)

        def call(impl="cuda"):
            return ops.select_topk(x, last, s_l, 5, 1.0, None, impl=impl,
                                   **kw)

        _, idx, _ = call()
        _, want, _ = call("plain")
        torch.cuda.synchronize()
        rows.append(dict(
            m=m, p=P, k=k,
            plan=getattr(ops.KERNELS["select_topk"], "last_plan", None),
            index_agreement=float((idx == want).float().mean()),
            ms=time_ms(call, iters), device_ms=graph_ms(call, iters)))
    return rows


def worker(root: Path, label: str) -> dict:
    import torch

    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    build.library()
    dev = torch.device("cuda", 0)
    return dict(run=label, root=str(root), mask_evolve=evolve_rows(ops, dev),
                select_topk=select_rows(ops, dev))


def main() -> int:
    if len(sys.argv) >= 4 and sys.argv[1] == "--worker":
        print(json.dumps(worker(Path(sys.argv[2]).resolve(), sys.argv[3])))
        return 0
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for i, root in enumerate(sys.argv[1:]):
        label = f"{i}_{Path(root).resolve().name}"
        res = subprocess.run([sys.executable, __file__, "--worker", root,
                              label], capture_output=True, text=True,
                             timeout=900)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
