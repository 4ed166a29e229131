"""How chaotic is f32 training of the reduced ResNet in the JAX reference?

Runs two PFedDST rounds (M=6, k=2, fused scoring, f32) of the reference
twice — once from its init, once from that init with the extractor
perturbed by 1e-7 (relative) — and prints, per round, the largest
difference between the two runs as a fraction of each leaf's scale. At
`cnn_width=16` the per-position GroupNorm normalises 2 channels per group
and the runs part by tens of percent; at 32 they stay ~1e-6 apart. This
is why the port's round parity test (tests/test_torch_round.py) runs at
width 32.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_gn_sensitivity.py
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.configs.base import FLConfig
from repro.core.client_state import init_population
from repro.core.partial_freeze import make_phase_steps
from repro.core.rounds import PFEDDST_STREAMS, make_pfeddst_stages
from repro.data.synthetic import client_datasets_cifar
from repro.fl.engine import run_round
from repro.optim.sgd import sgd


def worst(a, b) -> float:
    return max(float(jnp.abs(x - y).max() / jnp.abs(y).max())
               for x, y in zip(jax.tree_util.tree_leaves(a),
                               jax.tree_util.tree_leaves(b)))


def main():
    data = client_datasets_cifar(jax.random.PRNGKey(0), 6,
                                 samples_per_class=20, image_size=8)
    train = {"images": data["train_x"], "labels": data["train_y"]}
    fl = FLConfig(num_clients=6, peers_per_round=2, batch_size=8,
                  client_sample_ratio=0.5, epochs_extractor=1,
                  epochs_header=1, probe_size=4, use_score_kernel=True,
                  comms=None)
    for width in (16, 32):
        cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                                  dtype="float32", image_size=8,
                                  cnn_width=width)
        opt = sgd(fl.lr, momentum=fl.momentum, weight_decay=fl.weight_decay)
        stages = make_pfeddst_stages(cfg, fl, make_phase_steps(cfg, opt),
                                     steps_per_epoch=1, probe_size=4,
                                     use_score_kernel=True)
        rnd = jax.jit(lambda s, k, stages=stages: run_round(
            stages, s, train, k, m=6, ratio=0.5,
            key_streams=PFEDDST_STREAMS))
        a = init_population(cfg, jax.random.PRNGKey(1), 6, opt, opt)
        leaves, treedef = jax.tree_util.tree_flatten(a.extractor)
        rng = np.random.default_rng(0)
        b = a._replace(extractor=jax.tree_util.tree_unflatten(treedef, [
            leaf * (1 + 1e-7 * rng.standard_normal(leaf.shape)
                    .astype(np.float32)) for leaf in leaves]))
        for r in range(2):
            key = jax.random.fold_in(jax.random.PRNGKey(2), r)
            a, ma = rnd(a, key)
            b, mb = rnd(b, key)
            same = bool((ma["select_mask"] == mb["select_mask"]).all())
            print(f"width {width} round {r}: masks equal {same}, "
                  f"extractor {worst(b.extractor, a.extractor):.2e}, "
                  f"momentum {worst(b.opt_e['mu'], a.opt_e['mu']):.2e}, "
                  f"header {worst(b.header, a.header):.2e} "
                  "(max |diff| / max |leaf|)")


if __name__ == "__main__":
    main()
