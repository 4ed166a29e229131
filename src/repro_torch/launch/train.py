"""Federated training — the paper's §III experiment as a CLI
(reference `repro.launch.train`, with the same flags plus `--device`).

Runs any strategy (PFedDST and every baseline) over the synthetic-CIFAR
or the federated-token data, with periodic personalized evaluation and
an optional history JSON. `--ckpt-dir` is parsed and unused, as in the
reference (its `launch/train.py` imports `save_checkpoint` and never
calls it).

CPU-scale examples:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --strategy pfeddst --rounds 5 --clients 16 --reduced
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --strategy pfeddst --arch qwen2-1.5b --reduced --rounds 2 \\
      --clients 4 --peers 2 --batch-size 8 --sample-ratio 1.0
On a card drop `--device cpu` (and `--reduced` for full width).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.configs import get_config
from repro_torch.configs.base import FLConfig
from repro_torch.data.synthetic import client_datasets_cifar, synth_tokens
from repro_torch.device import resolve_device
from repro_torch.fl.simulator import run_experiment


def build_data(cfg, fl, seed: int, *, samples_per_class=100, image_size=32,
               seq_len=64, seqs_per_client=64) -> dict:
    """The run's client data, leading-M stacked CPU tensors: the
    pathological synthetic-CIFAR split for the cnn; for an LLM,
    `synth_tokens` streams cut into test (the first max(1, n // 5)
    sequences) and train, with zero labels (next-token targets)."""
    if cfg.family == "cnn":
        return client_datasets_cifar(
            seed, fl.num_clients, num_classes=cfg.num_classes,
            classes_per_client=fl.classes_per_client,
            samples_per_class=samples_per_class, image_size=image_size)
    tokens, _ = synth_tokens(seed, fl.num_clients, cfg.vocab_size, seq_len,
                             seqs_per_client=seqs_per_client)
    n_te = max(1, seqs_per_client // 5)
    return {"train_x": tokens[:, n_te:], "train_y": tokens[:, n_te:, 0] * 0,
            "test_x": tokens[:, :n_te], "test_y": tokens[:, :n_te, 0] * 0}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="resnet18-cifar")
    ap.add_argument("--strategy", default="pfeddst")
    ap.add_argument("--rounds", type=int, default=500)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--peers", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--sample-ratio", type=float, default=0.1)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--steps-per-epoch", type=int, default=2)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--samples-per-class", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size model (CPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="history JSON path")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    fl = FLConfig(num_clients=args.clients, peers_per_round=args.peers,
                  batch_size=args.batch_size,
                  client_sample_ratio=args.sample_ratio, lr=args.lr,
                  seed=args.seed)
    data = build_data(cfg, fl, args.seed,
                      samples_per_class=args.samples_per_class,
                      image_size=args.image_size, seq_len=args.seq_len)
    hist = run_experiment(args.strategy, cfg, fl, data,
                          num_rounds=args.rounds, eval_every=args.eval_every,
                          steps_per_epoch=args.steps_per_epoch,
                          seed=args.seed, device=device)
    record = {"arch": cfg.name, "strategy": args.strategy,
              "fl": dataclasses.asdict(fl), **hist.to_dict()}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"history -> {args.out}")
    print(f"final personalized accuracy: {hist.accuracy[-1]:.4f} "
          f"({args.strategy}, {args.rounds} rounds)")
    return record


if __name__ == "__main__":
    main()
