"""Checkpointing — a tree of tensors ↔ npz with a JSON manifest,
reference `repro.checkpoint.checkpoint`, in its on-disk format (the zip
container's timestamps aside):

* one npz entry per leaf, named by its `utils.pytree.tree_paths` path
  with "/" replaced by "__" (no pickle);
* bfloat16 leaves stored as their uint16 bit patterns (npz has no
  bfloat16; the port moves the bits through an int16 view, so it needs
  no numpy bfloat16 type);
* a JSON manifest beside it with `step`, `paths`, `dtypes` (the true
  dtype per path, numpy's names) and `extra`;
* an atomic write: a temporary file in the directory, then a rename.

So a checkpoint either package writes reads back bitwise in the other.
The reference's restore can re-shard leaves onto a mesh (`shardings=`);
one card has no mesh, so `load_checkpoint` takes `device=` instead and
places the leaves there (default "cuda", which raises without a card;
pass "cpu" to restore on the host). With `like=`, a leaf whose
counterpart in `like` is a CPU tensor stays on the CPU: the port keeps
some scalars on the host by design (`PopulationState.round`), and the
restored tree keeps them there.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.utils.pytree import tree_paths, tree_unflatten_paths

def _sanitize(path: str) -> str:
    return path.replace("/", "__")


def _to_numpy(x) -> tuple:
    """(array to store, numpy dtype name of the leaf)."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        return a, str(a.dtype)
    t = x.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    return t.cpu().numpy(), str(t.dtype).removeprefix("torch.")


def _to_tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    a = np.array(a, order="C")          # writable, keeps 0-d leaves 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def save_checkpoint(directory: str, step: int, tree,
                    extra: dict | None = None):
    """Write <dir>/ckpt_<step>.npz (+ .json manifest) → the npz path."""
    os.makedirs(directory, exist_ok=True)
    pairs = tree_paths(tree)
    arrays, dtypes = {}, {}
    for p, x in pairs:
        arrays[_sanitize(p)], dtypes[p] = _to_numpy(x)
    manifest = {
        "step": int(step),
        "paths": [p for p, _ in pairs],
        "dtypes": dtypes,
        "extra": extra or {},
    }
    base = os.path.join(directory, f"ckpt_{step:08d}")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, base + ".npz")
    with open(base + ".json", "w") as f:
        json.dump(manifest, f)
    return base + ".npz"


def load_checkpoint(path: str, like=None, *, device="cuda"):
    """Load a checkpoint → (tree, manifest), every leaf a tensor of its
    manifest dtype on `device`.

    like: a tree of the saved structure (dicts, lists, tuples,
    NamedTuples); the result has its structure, and a leaf whose `like`
    counterpart is a CPU tensor stays on the CPU. Without it the result
    is {path: tensor}."""
    device = resolve_device(device)
    with open(path.replace(".npz", ".json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    with np.load(path) as data:
        by_path = {p: _to_tensor(data[_sanitize(p)], dtypes.get(p, ""),
                                 device) for p in manifest["paths"]}
    if like is None:
        return by_path, manifest
    paths = [p for p, _ in tree_paths(like)]
    missing = [p for p in paths if p not in by_path]
    if missing or len(paths) != len(by_path):
        raise ValueError(f"checkpoint {path} does not match the tree: "
                         f"missing {missing[:5]}, {len(by_path)} saved "
                         f"leaves for {len(paths)}")
    def place(p, leaf):
        host = isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
        return by_path[p].cpu() if host else by_path[p]

    return tree_unflatten_paths(like, place), manifest


def latest_checkpoint(directory: str):
    """The newest ckpt_<step>.npz in `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    ckpts = [f for f in os.listdir(directory)
             if re.match(r"ckpt_\d+\.npz$", f)]
    if not ckpts:
        return None
    return os.path.join(directory, sorted(ckpts)[-1])
