#!/usr/bin/env python3
"""A/B of the port's raw_gram kernel between checkouts, on one CUDA card.

    python3 tools/raw_gram_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout (a directory holding
`src/repro_torch`). The checkouts run one after another in the order
given, each in a process of its own that builds the checkout's kernels
with its own `kernels/build.py` and calls its own `ops.raw_gram`, so
two checkouts with different C interfaces compare. Each run prints one
JSON line: for M ∈ {16, 1024, 4096}, P = 5130 (the ResNet-18 header),
the time per Python call (CUDA events over back-to-back calls) and on
the device alone (CUDA-graph replay), beside `torch.matmul`'s; and, from
`cuobjdump -sass` of the built library, each raw_gram kernel's
instruction count and the opcodes in which it differs from the first
run's kernel of the same name (the template arguments stripped, so
`raw_gram_kernel<64, 0>` meets an earlier `raw_gram_kernel`). The
SASS itself goes to `chiprun_out/raw_gram_sass_<run>.txt`. The card's
name and power limit come first.
"""
from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parent.parent / "chiprun_out"
P = 5130
CASES = ((16, 400), (1024, 40), (4096, 20))   # (M, iterations)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int, per_graph: int = 20) -> float:
    """Device time of one call: `per_graph` calls captured in a CUDA
    graph and replayed, so the host's per-call cost is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return time_ms(graph.replay, max(2, iters // per_graph)) / per_graph


def sass_kernels(so: Path, nvcc: str) -> tuple[dict, str]:
    """({kernel name: [opcodes in order]} of the raw_gram kernels in the
    library's SASS, their SASS text)."""
    cuobj = Path(nvcc).parent / "cuobjdump"
    text = subprocess.run([str(cuobj), "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return parse_sass(text)


def parse_sass(text: str) -> tuple[dict, str]:
    kernels, name, keep = {}, None, []
    for line in text.splitlines():
        if "Function :" in line:
            sym = line.split("Function :")[1].strip()
            # …15raw_gram_kernelILi64ELb0EE… → raw_gram_kernel<64, 0>
            found = re.search(r"\d+(raw_gram\w*?kernel)", sym)
            name = found.group(1) if found else None
            targs = re.search(r"kernelILi(\d+)ELb([01])E", sym)
            if found and targs:
                name += f"<{targs.group(1)}, {targs.group(2)}>"
            if name is not None:
                kernels[name] = []
        if name is None:
            continue
        keep.append(line)
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m:
            kernels[name].append(m.group(1))
    return kernels, "\n".join(keep)


def worker(root: Path, label: str) -> dict:
    import torch

    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    so = build.build()
    build.library()
    ptxas, keep = [], False      # the ptxas report of the raw_gram kernels
    for ln in build.BUILD_LOG.splitlines():
        if "Compiling entry function" in ln:
            keep = "raw_gram" in ln
        if keep:
            ptxas.append(ln.strip())
    dev = torch.device("cuda", 0)
    rows = []
    for m, iters in CASES:
        g = torch.Generator(device=dev).manual_seed(m)
        x = torch.randn((m, P), generator=g, device=dev)
        got = ops.raw_gram(x, impl="cuda")
        want = x @ x.T
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) / float(want.abs().max())
        rows.append(dict(
            m=m, p=P, rel_err=err,
            plan=getattr(ops.KERNELS["raw_gram"], "last_plan", None),
            ms=time_ms(lambda: ops.raw_gram(x, impl="cuda"), iters),
            device_ms=graph_ms(lambda: ops.raw_gram(x, impl="cuda"), iters),
            matmul_ms=time_ms(lambda: torch.matmul(x, x.T), iters),
            matmul_device_ms=graph_ms(lambda: torch.matmul(x, x.T), iters)))
    kernels, text = sass_kernels(so, build.nvcc_path())
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"raw_gram_sass_{label}.txt").write_text(text)
    return dict(run=label, root=str(root), rows=rows, ptxas=ptxas,
                sass=kernels)


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
    first = {}
    for i, root in enumerate(sys.argv[1:]):
        label = f"{i}_{Path(root).resolve().name}"
        res = subprocess.run([sys.executable, __file__, "--worker", root,
                              label], capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        run = json.loads(res.stdout.strip().splitlines()[-1])
        sass = run.pop("sass")
        run["sass"] = {}
        for name, ops_ in sass.items():
            base = re.sub(r"<.*>", "", name)
            ref = first.setdefault(base, (name, ops_))
            diff = collections.Counter(ops_)
            diff.subtract(collections.Counter(ref[1]))
            run["sass"][name] = dict(
                instructions=len(ops_), against=ref[0],
                identical=ops_ == ref[1],
                opcode_diff={k: v for k, v in diff.items() if v})
        print(json.dumps(run), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
