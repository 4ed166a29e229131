"""Quickstart — the PFedDST public API of the port in ~60 lines, the
twin of the reference's `examples/quickstart.py`.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a 6-client population on synthetic non-IID CIFAR, runs 3 PFedDST
communication rounds (score → select → aggregate → two-phase train), and
prints the selection masks and the personalized accuracy. The rounds run
on the card by default (`--device cpu` runs the plain versions).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import FLConfig
from repro_torch.core import init_population, make_phase_steps, pfeddst_round
from repro_torch.data.synthetic import client_datasets_cifar
from repro_torch.device import resolve_device
from repro_torch.fl import evaluate_population
from repro_torch.models.split import merge_params
from repro_torch.optim.sgd import sgd


def build_config():
    """The reduced model and the FL config of the quickstart."""
    cfg = get_config("resnet18-cifar").reduced()
    fl = FLConfig(num_clients=6, peers_per_round=2, batch_size=16,
                  client_sample_ratio=0.5, probe_size=8)
    return cfg, fl


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. model + FL config (paper §III-A hyper-parameters, smoke scale)
    cfg, fl = build_config()

    # 2. non-IID data: each client sees 2 of 10 classes (pathological)
    data = client_datasets_cifar(0, fl.num_clients, classes_per_client=2,
                                 samples_per_class=40, image_size=16)
    data = {k: v.to(dev) for k, v in data.items()}
    train = {"images": data["train_x"], "labels": data["train_y"]}

    # 3. population state: per-client (extractor, header, optimizer, context)
    opt = sgd(fl.lr, momentum=fl.momentum, weight_decay=fl.weight_decay)
    state = init_population(cfg, torch.Generator(device=dev).manual_seed(0),
                            fl.num_clients, opt, opt, dev)
    steps = make_phase_steps(cfg, opt)

    # 4. communication rounds (Algorithm 1), round r keyed (0, r)
    for r in range(3):
        state, metrics = pfeddst_round(cfg, fl, steps, state, train, (0, r),
                                       probe_size=fl.probe_size)
        sel = metrics["select_mask"].int()
        print(f"round {r}: loss_e={float(metrics['train_loss_e']):.3f} "
              f"selections per active client = {sel.sum(1).tolist()}")

    # 5. personalized evaluation: client i's model on client i's test data
    params = merge_params(state.extractor, state.header)
    acc, per_client = evaluate_population(cfg, params, data["test_x"],
                                          data["test_y"])
    print(f"personalized accuracy: mean={float(acc):.3f} "
          f"per-client={[round(float(a), 2) for a in per_client]}")
    return {"state": state, "metrics": metrics, "accuracy": float(acc)}


if __name__ == "__main__":
    main()
