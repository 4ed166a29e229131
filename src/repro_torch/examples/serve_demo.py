"""Batched serving demo — prefill + greedy decode across model families,
the twin of the reference's `examples/serve_demo.py`.

    python -m repro_torch.examples.serve_demo                  # on a card
    python -m repro_torch.examples.serve_demo --device cpu
    python -m repro_torch.examples.serve_demo --archs rwkv6-7b whisper-base

Serves a batch of requests through each family's cache type (dense GQA
KV / MoE / MLA latent / WKV state / LRU + ring window) with
`launch.serve.generate`, whose prefill takes backend "flash": on a card
the flash_attention kernel (and wkv_chunked for rwkv6), on the CPU their
plain versions. The reference's flags and defaults (each arch
`.reduced()`, batch 4, prompt 16, 8 greedy tokens) and its line per
arch; `--device` (default cuda), `--seed` and `--dtype` (default each
config's own, bf16) are the port's. Weights and prompts are drawn on the
CPU from the seed, then moved to the device, so a card run and a CPU run
serve the same ones. In bf16 their greedy tokens can part (the card's
kernels and GEMMs round otherwise than the CPU's plain versions); in
float32 they are equal (`chip_smoke.py` phase 13).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import model as model_mod
from repro_torch.utils.pytree import tree_map

DEFAULT_ARCHS = ["qwen2-1.5b", "deepseek-v3-671b", "rwkv6-7b",
                 "recurrentgemma-2b"]


def make_inputs(cfg, batch: int, prompt_len: int, seed: int):
    """(params, prompts (batch, prompt_len) int32), drawn on the CPU from
    `seed`."""
    g = torch.Generator().manual_seed(seed)
    params = model_mod.init_params(cfg, g, "cpu")
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=g, dtype=torch.int32)
    return params, prompts


def serve_arch(cfg, params, prompts, gen: int, device="cuda"):
    """Greedy `generate` of `gen` tokens on `device` → ((B, S + gen)
    tokens on the CPU, wall seconds)."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    prompts = prompts.to(dev)
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, gen_tokens=gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out.cpu(), time.perf_counter() - t0


def main(argv=None) -> dict:
    """→ {arch: (B, S + gen) greedy tokens}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="*", default=list(DEFAULT_ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default=None,
                    help="every config's dtype (default: its own)")
    args = ap.parse_args(argv)

    out = {}
    for arch in args.archs:
        cfg = get_config(arch).reduced()
        if cfg.family == "cnn":
            continue
        if args.dtype:
            cfg = dataclasses.replace(cfg, dtype=args.dtype)
        params, prompts = make_inputs(cfg, args.batch, args.prompt_len,
                                      args.seed)
        toks, secs = serve_arch(cfg, params, prompts, args.gen, args.device)
        n = args.batch * args.gen
        print(f"{arch:25s} [{cfg.family:6s}] {n} tokens in "
              f"{secs:5.1f}s  sample={toks[0, -4:].tolist()}")
        out[arch] = toks
    return out


if __name__ == "__main__":
    main()
