#!/usr/bin/env python3
"""A/B of the port's gossip_mix kernel between checkouts, on one CUDA card.

    python3 tools/gossip_mix_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout (a directory holding
`src/repro_torch`). The checkouts run one after another in the order
given, each in a process of its own that builds the checkout's kernels
with its own `kernels/build.py` and calls its own `kernels.ops`. Each run
prints one JSON line with, for each case, the kernel's time per call
(CUDA events over back-to-back calls), whether its output is bitwise
equal to the checkout's `gossip_mix_plain`, and, where the case has one,
the dense matrix product of the same plan (`torch.matmul` of the
scattered (M, M) weights by x):

* `ring`: M = 16, F = 11,172,170 (the whole ResNet-18, F mod 4 = 2),
  D = 3: each row mixes itself and its two ring neighbours, as
  dfedavgm's and dispfl's plans pack on a ring.
* `dfedpgp`: M = 16, F = 11,167,040 (the ResNet-18 extractor, F mod 4 =
  0), D = 5: four active rows mix themselves and four others.
* `packed`: M = 65536, F = 5130 (the ResNet-18 header, F mod 4 = 2),
  D = 5: each row mixes itself and four neighbours of its cluster of 16.

The card's name and power limit come first.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from raw_gram_ab import time_ms

CASES = {"ring": (16, 11_172_170, 20), "dfedpgp": (16, 11_167_040, 20),
         "packed": (65536, 5130, 20)}         # M, F, iterations


def plan(name: str, m: int, dev):
    """(idx (M, D) int32 ascending, w (M, D) f32) of the case."""
    import torch

    rows = torch.arange(m, device=dev)
    if name == "ring":
        idx = torch.stack([(rows - 1) % m, rows, (rows + 1) % m], 1)
    elif name == "dfedpgp":
        idx = rows[:, None].repeat(1, 5)
        for i in range(4):                    # rows 0..3 active
            idx[i] = torch.tensor([i, 4 + i, 8 + i, 12 + i, (i + 5) % 16])
    else:
        base = rows - rows % 16
        idx = torch.stack([base + (rows + s) % 16 for s in (-2, -1, 0, 1, 2)],
                          1)
    idx = idx.sort(1).values.int().contiguous()
    w = torch.full(idx.shape, 1.0 / idx.shape[1], device=dev)
    if name == "dfedpgp":
        w[4:] = 0.0
        w[4:, 0] = 1.0
    return idx, w


def worker(root: Path, label: str) -> dict:
    import torch

    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.gossip_mix import (gossip_mix_plain,
                                                neighbors_to_dense)

    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    dev = torch.device("cuda", 0)
    rows = {}
    for name, (m, f, iters) in CASES.items():
        g = torch.Generator(device=dev).manual_seed(m + f)
        x = torch.randn((m, f), generator=g, device=dev)
        idx, w = plan(name, m, dev)
        got = ops.gossip_mix(x, idx, w, impl="cuda")
        want = gossip_mix_plain(x, idx, w)
        row = dict(m=m, f=f, d=idx.shape[1],
                   bitwise=bool(torch.equal(got.view(torch.int32),
                                            want.view(torch.int32))),
                   ms=time_ms(lambda: ops.gossip_mix(x, idx, w, impl="cuda"),
                              iters))
        del got, want
        if m <= 16:
            dense = neighbors_to_dense(idx, w, m)
            row["matmul_ms"] = time_ms(lambda: dense @ x, iters)
        rows[name] = row
        del x
        torch.cuda.empty_cache()
    return dict(run=label, root=str(root), rows=rows)


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
                             timeout=600)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
