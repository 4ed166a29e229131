"""Does PFedDST stay finite at the paper's lr 0.1 in bf16, in the JAX
reference and in the PyTorch port, under the same settings?

Run as a script, it runs `run_experiment("pfeddst")` of one package — the
reference (`--package repro`) or the port (`--package repro_torch`) — on a
reduced ResNet-18 (full channel widths, one block per stage, 16×16
images, bf16) with the `--paper-scale` recipe of `examples/fl_cifar_sim.py`
otherwise (peers 4, ratio 0.25, probe 16, K_e=5, K_h=1, 2 steps per
epoch, lr 0.1 and the 0.01 control) at M=8, batch 32, 40 samples per
class, for 10 rounds and seeds 0 and 1, evaluating every round, and
prints every round's train_loss and accuracy. One process imports one
package; run it once per package and compare the lines. The two packages
draw their data and weights from their own generators, so their losses
agree in kind, not in bits (minutes per run on a CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lr_divergence.py --package repro
    PYTHONPATH=src python tests/test_torch_lr_divergence.py --package repro_torch --device cpu

As a test, it holds the model fields the CNN reads and the FL configs of
that run equal across the two packages, so the comparison is of the
same settings.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import math
import time

import pytest

M, BATCH, SPC, IMG, ROUNDS = 8, 32, 40, 16, 10
LRS = (0.1, 0.01)


def _config(package: str):
    configs = importlib.import_module(f"{package}.configs")
    return dataclasses.replace(configs.get_config("resnet18-cifar"),
                               cnn_stages=(1, 1, 1, 1), image_size=IMG,
                               dtype="bfloat16")


def _fl(package: str, lr: float):
    base = importlib.import_module(f"{package}.configs.base")
    return base.FLConfig(num_clients=M, peers_per_round=4, batch_size=BATCH,
                         client_sample_ratio=0.25, probe_size=16, comms=None,
                         lr=lr)


def _data(package: str):
    synth = importlib.import_module(f"{package}.data.synthetic")
    if package == "repro":
        import jax
        return synth.client_datasets_cifar(
            jax.random.PRNGKey(0), M, classes_per_client=2,
            samples_per_class=SPC, image_size=IMG)
    return synth.client_datasets_cifar(
        0, M, classes_per_client=2, samples_per_class=SPC, image_size=IMG)


# the model config's fields the CNN reads (the rest is LLM metadata)
CNN_FIELDS = ("family", "cnn_stages", "cnn_width", "image_size",
              "image_channels", "num_classes", "dtype")


@pytest.mark.parametrize("lr", LRS)
def test_probe_runs_both_packages_on_the_same_settings(lr):
    ref, port = _config("repro"), _config("repro_torch")
    assert ({k: getattr(ref, k) for k in CNN_FIELDS}
            == {k: getattr(port, k) for k in CNN_FIELDS})
    a = dataclasses.asdict(_fl("repro", lr))
    b = dataclasses.asdict(_fl("repro_torch", lr))
    assert set(b) <= set(a)
    assert {k: a[k] for k in b} == b


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", required=True,
                    choices=["repro", "repro_torch"])
    ap.add_argument("--device", default="cpu",
                    help="the port's device (ignored for the reference)")
    ap.add_argument("--lrs", type=float, nargs="*", default=list(LRS))
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1])
    args = ap.parse_args(argv)
    cfg, data = _config(args.package), _data(args.package)
    run_experiment = importlib.import_module(
        f"{args.package}.fl").run_experiment
    extra = {} if args.package == "repro" else {"device": args.device}
    for lr in args.lrs:
        fl = _fl(args.package, lr)
        for seed in args.seeds:
            t0 = time.time()
            h = run_experiment("pfeddst", cfg, fl, data, num_rounds=ROUNDS,
                               eval_every=1, steps_per_epoch=2, seed=seed,
                               verbose=False, **extra).to_dict()
            losses = h["train_loss"]
            first_nan = next((r for r, x in zip(h["rounds"], losses)
                              if not math.isfinite(x)), None)
            print(f"{args.package} lr={lr} seed={seed} "
                  f"train_loss={losses} accuracy={h['accuracy']} "
                  f"first_nonfinite_round={first_nan} "
                  f"wall_s={time.time() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
