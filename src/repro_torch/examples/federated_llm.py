"""Federated LLM personalization — PFedDST on an LLM backbone, the twin
of the reference's `examples/federated_llm.py` (same flags and printout,
plus `--device`).

Clients hold heterogeneous text domains (disjoint vocab slices over a
shared background, `synth_tokens`); PFedDST federates the trunk (the
extractor) while each client keeps a personal lm_head + final_norm (the
header). The header cosine then shows whether the score finds
same-domain peers. The model is the arch's reduced config, as in the
reference.

    PYTHONPATH=src python -m repro_torch.examples.federated_llm \\
        --arch qwen2-1.5b --device cpu
    PYTHONPATH=src python -m repro_torch.examples.federated_llm \\
        --arch rwkv6-7b --device cpu

Drop `--device cpu` on a card.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import FLConfig
from repro_torch.core import init_population, make_phase_steps, pfeddst_round
from repro_torch.core.client_state import client_rows
from repro_torch.core.scoring import flatten_headers, header_distance_matrix
from repro_torch.data.synthetic import synth_tokens
from repro_torch.device import resolve_device
from repro_torch.models import model as model_mod
from repro_torch.models.split import merge_params
from repro_torch.optim.sgd import sgd


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--domains", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    fl = FLConfig(num_clients=args.clients, peers_per_round=2, batch_size=8,
                  client_sample_ratio=1.0, lr=0.05, probe_size=4)

    tokens, domains = synth_tokens(args.seed, args.clients, cfg.vocab_size,
                                   args.seq_len, seqs_per_client=32,
                                   num_domains=args.domains)
    train = {"tokens": tokens.to(dev)}
    print(f"arch={cfg.name} family={cfg.family} "
          f"client domains: {domains.tolist()}")

    opt = sgd(fl.lr, momentum=fl.momentum, weight_decay=fl.weight_decay)
    state = init_population(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), args.clients, opt, opt, dev)
    steps = make_phase_steps(cfg, opt)
    for r in range(args.rounds):
        state, metrics = pfeddst_round(cfg, fl, steps, state, train,
                                       (args.seed, r),
                                       probe_size=fl.probe_size)
        print(f"round {r}: loss_e={float(metrics['train_loss_e']):.3f} "
              f"loss_h={float(metrics['train_loss_h']):.3f}")

    # do headers cluster by domain? (the paper's Eq. 7 rationale)
    s_d = header_distance_matrix(flatten_headers(state.header)).cpu()
    same = domains[:, None] == domains[None, :]
    off = ~torch.eye(args.clients, dtype=torch.bool)
    same_mean = float(torch.where(same & off, s_d, 0).sum()
                      / (same & off).sum())
    diff_mean = float(torch.where(~same, s_d, 0).sum() / (~same).sum())
    print(f"header cosine: same-domain={same_mean:.4f} "
          f"cross-domain={diff_mean:.4f} "
          f"(same > cross ⇒ the score finds task structure)")

    params = merge_params(state.extractor, state.header)
    with torch.no_grad():
        loss0 = model_mod.eval_loss(cfg, client_rows(params, 0),
                                    {"tokens": train["tokens"][0, :4]})
    print(f"client-0 local eval loss: {float(loss0):.3f}")
    return {"state": state, "metrics": metrics, "same": same_mean,
            "cross": diff_mean, "loss0": float(loss0)}


if __name__ == "__main__":
    main()
