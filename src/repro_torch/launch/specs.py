"""Dry-run input structs + sharding specs per (arch × input-shape × mesh)
(reference `repro.launch.specs`).

"Structs" are tensors on the `meta` device with the reference's shapes
and dtypes: params, optimizer states, batches and KV caches are
described, never drawn or allocated (the full configs reach 671 B
parameters). The same functions given a real device and a generator
build real inputs of the same layout (`chip_smoke.py` phase 13 runs the
dry run's steps on them).

Layouts (the reference's baseline policy; a spec is a plain tuple, see
`utils/sharding.py`):
  params       rule engine in utils/sharding.py (TP on "model", FSDP on
               "data"); the stacked-layer leading dim is never sharded.
  opt state    mirrors the param layout (momentum has the param's shape).
  batch        tokens/labels (B, S): batch over the data meta-axis.
  KV caches    batch over "data"; the *sequence* dim over "model".
  rwkv state   heads over "model" (S (L,B,H,hd,hd) has no seq dim).
  MLA cache    latent is head-free: batch over "data", seq over "model".

Multi-pod: the "pod" axis merges into the data meta-axis, or into
"model" for long_500k (MeshAxes.from_mesh(pod_merge=...)).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models import model as model_mod
from repro_torch.utils.sharding import (MeshAxes, ShardingRules, _div,
                                        tree_map_with_path_str)
from repro_torch.utils.pytree import tree_leaves


# ---------------------------------------------------------------------------
# axes selection per shape
# ---------------------------------------------------------------------------

def axes_for(mesh, shape: InputShape) -> MeshAxes:
    """Multi-pod merge policy: pod→data except long_500k (pod→model)."""
    pod_merge = "model" if shape.name == "long_500k" else "data"
    return MeshAxes.from_mesh(mesh, pod_merge=pod_merge)


# ---------------------------------------------------------------------------
# params + optimizer state
# ---------------------------------------------------------------------------

def param_structs(cfg: ModelConfig, device="meta", generator=None):
    """Param tree on `device`: meta tensors (nothing drawn) by default,
    else `init_params`' draws from `generator`."""
    return model_mod.init_params(cfg, generator, device)


def param_specs(cfg: ModelConfig, params_sds, axes: MeshAxes):
    rules = ShardingRules(axes=axes)
    return rules.tree_param_specs(params_sds)


def opt_structs(opt, params_sds):
    return opt.init(params_sds)


def opt_specs(cfg: ModelConfig, opt_sds, axes: MeshAxes):
    """Momentum mirrors param sharding; scalars replicate."""
    rules = ShardingRules(axes=axes)

    def spec(path, leaf):
        if leaf.dim() == 0:
            return ()
        # strip the optimizer-state prefix (mu/, nu/, …) → param path
        parts = path.split("/")
        ppath = "/".join(parts[1:]) if len(parts) > 1 else path
        return rules.param_spec(ppath, tuple(leaf.shape))

    return tree_map_with_path_str(spec, opt_sds)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def batch_structs(cfg: ModelConfig, batch: int, seq: int, device="meta",
                  generator=None):
    """Model-input batch dict (tokens + the modality stubs, bf16 as in
    the reference). On a real device: tokens uniform over the vocabulary
    and N(0, 1) stubs, drawn from `generator`."""
    shapes = {"tokens": ((batch, seq), torch.int32)}
    if cfg.family == "audio":
        shapes["frames"] = ((batch, cfg.encoder_seq, cfg.d_model),
                            torch.bfloat16)
    if cfg.family == "vlm":
        shapes["prefix_embeds"] = ((batch, cfg.num_prefix_tokens,
                                    cfg.d_model), torch.bfloat16)
    if torch.device(device).type == "meta":
        return {k: torch.empty(s, dtype=dt, device=device)
                for k, (s, dt) in shapes.items()}
    out = {}
    for k, (s, dt) in shapes.items():
        if dt == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, s, dtype=dt,
                                   device=device, generator=generator)
        else:
            out[k] = torch.randn(s, device=device,
                                 generator=generator).to(dt)
    return out


def batch_specs(cfg: ModelConfig, batch_sds, axes: MeshAxes):
    d = axes.data_name if _div(
        tree_leaves(batch_sds)[0].shape[0], axes.data
    ) else None

    def spec(path, leaf):
        return tuple([d] + [None] * (leaf.dim() - 1))

    return tree_map_with_path_str(spec, batch_sds)


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def cache_structs(cfg: ModelConfig, batch: int, max_seq: int,
                  device="meta"):
    return model_mod.init_cache(cfg, batch, max_seq, device)


def cache_specs(cfg: ModelConfig, cache_sds, axes: MeshAxes, max_seq: int):
    """Heuristic per-leaf cache layout with divisibility fallbacks."""
    d, m = axes.data_name, axes.model_name

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        p = path.lower()

        def dax(n):
            return d if _div(n, axes.data) else None

        def max_(n):
            return m if _div(n, axes.model) else None

        # rwkv WKV state (L, B, H, hd, hd): heads on model
        if p.endswith("/s") or "/s/" in p or p == "s":
            if nd == 5:
                return (None, dax(shape[1]), max_(shape[2]), None, None)
            if nd == 4:  # (B, H, hd, hd) unstacked
                return (dax(shape[0]), max_(shape[1]), None, None)
        # prev_x (L, B, D) or (B, D): model on D
        if "prev_x" in p:
            if nd == 3:
                return (None, dax(shape[1]), max_(shape[2]))
            if nd == 2:
                return (dax(shape[0]), max_(shape[1]))
        # MLA latent (L, B, S, R): seq on model
        if "c_kv" in p or "k_rope" in p:
            return (None, dax(shape[1]), max_(shape[2]), None)
        # LRU state (B, W) / conv tail etc: model on width
        if "lru" in p or "hidden" in p:
            if nd == 2:
                return (dax(shape[0]), max_(shape[1]))
        # dense/enc-dec KV (L, B, S, K, hd) or hybrid ring (B, W, K, hd):
        if nd == 5:
            return (None, dax(shape[1]), max_(shape[2]), None, None)
        if nd == 4:
            return (dax(shape[0]), max_(shape[1]), None, None)
        if nd == 3:
            return (dax(shape[0]), max_(shape[1]), None)
        if nd == 2:
            return (dax(shape[0]), max_(shape[1]))
        return (None,) * nd

    return tree_map_with_path_str(spec, cache_sds)


# ---------------------------------------------------------------------------
# the assignment's input_specs() entry point
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape_name: str, opt=None):
    """Meta-tensor stand-ins for every input of the step function of
    `shape_name` for architecture `cfg` (the dry-run contract).

    → dict with keys depending on shape kind:
      train:   extractor, header, opt_e, opt_h, batch
      prefill: params, batch
      decode:  params, cache, tokens, pos
    """
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        from repro_torch.models.split import split_params
        from repro_torch.optim.sgd import sgd

        opt = opt or sgd(0.1, momentum=0.9, weight_decay=0.005)
        e_sds, h_sds = split_params(cfg, param_structs(cfg))
        return {
            "extractor": e_sds,
            "header": h_sds,
            "opt_e": opt.init(e_sds),
            "opt_h": opt.init(h_sds),
            "batch": batch_structs(cfg, shape.global_batch, shape.seq_len),
        }
    if shape.kind == "prefill":
        return {
            "params": param_structs(cfg),
            "batch": batch_structs(cfg, shape.global_batch, shape.seq_len),
        }
    # decode
    return {
        "params": param_structs(cfg),
        "cache": cache_structs(cfg, shape.global_batch, shape.seq_len),
        "tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                              device="meta"),
        "pos": torch.empty((), dtype=torch.int32, device="meta"),
    }
