"""Does the paper's SGD recipe keep the full-model baselines finite in the
JAX reference?

Runs the reference's `run_experiment` for dfedpgp and fedavg (the
full-model SGD step every baseline but fedbabu takes) on a reduced
ResNet-18 — full channel widths, one block per stage, 16×16 images —
with M=8, 4 peers, ratio 0.25, batch 32, K_e=5, 2 steps per epoch, in
bf16, at the paper's lr 0.1 and at 0.01, seeds 0 and 1, and prints the
per-round train_loss and accuracy. At 0.1 the first round's losses
reach 15 to 2513 and two of the four runs are NaN in the second round;
at 0.01 they stay below 0.7. This is why chip_smoke.py runs the port's
baselines at lr 0.01 on the full model.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_lr_divergence.py
"""
from __future__ import annotations

import dataclasses

import jax

from repro.configs import get_config
from repro.configs.base import FLConfig
from repro.data.synthetic import client_datasets_cifar
from repro.fl.simulator import run_experiment


def main():
    cfg = dataclasses.replace(get_config("resnet18-cifar"),
                              cnn_stages=(1, 1, 1, 1), image_size=16,
                              dtype="bfloat16")
    data = client_datasets_cifar(jax.random.PRNGKey(0), 8,
                                 classes_per_client=2, samples_per_class=40,
                                 image_size=16)
    for lr in (0.1, 0.01):
        fl = FLConfig(num_clients=8, peers_per_round=4, batch_size=32,
                      client_sample_ratio=0.25, probe_size=16, comms=None,
                      lr=lr)
        for name in ("dfedpgp", "fedavg"):
            for seed in (0, 1):
                h = run_experiment(name, cfg, fl, data, num_rounds=2,
                                   eval_every=1, steps_per_epoch=2,
                                   seed=seed, verbose=False).to_dict()
                print(f"lr={lr} {name} seed={seed} "
                      f"train_loss={h['extra']['train_loss']} "
                      f"accuracy={h['accuracy']}", flush=True)


if __name__ == "__main__":
    main()
