"""How far apart are the JAX reference's two prefill routes?

The reference's serving module prefills with backend="naive"
(`repro/launch/serve.py`), which never reaches its Pallas kernels; the
PyTorch port's serving module prefills with backend="flash", the route of the
hand-written kernels. This script runs the reference's own
`model.prefill` by both routes (the Pallas kernels in interpret mode) on
the reduced qwen2-1.5b and rwkv6-7b configs, batch 2, 80 tokens, in
float32 and bfloat16, and prints the largest difference of the logits
beside their scale.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_prefill_routes.py
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import model as model_mod


def main():
    for arch in ("qwen2-1.5b", "rwkv6-7b"):
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
            params = model_mod.init_params(cfg, jax.random.PRNGKey(0))
            toks = jnp.asarray(np.random.default_rng(1).integers(
                0, cfg.vocab_size, size=(2, 80)), jnp.int32)
            logits = {
                backend: np.asarray(model_mod.prefill(
                    cfg, params, {"tokens": toks}, max_seq=88,
                    backend=backend)[0].astype(jnp.float32))
                for backend in ("naive", "flash")}
            diff = np.abs(logits["flash"] - logits["naive"]).max()
            scale = np.abs(logits["naive"]).max()
            print(f"{arch:11s} {dtype:8s} max |flash - naive| = {diff:.3e} "
                  f"(max |logit| {scale:.3f})")


if __name__ == "__main__":
    main()
