"""Carry parameters and population state across from the JAX reference.

The reference keeps cnn parameters as a nested pytree (dicts, and a list
of stages of blocks) with HWIO conv weights; the port keeps a flat dict
of dotted names with OIHW conv weights. These functions convert numpy
trees (the reference's arrays after `np.asarray`) to the port's tensors
and back, so a test can feed both packages the same state and compare in
the reference's layout: the PFedDST PopulationState (with
pfeddst_async's peer store), and the baselines'
dict states (params, optimizer state, round, dispfl's masks). Leaves may
carry leading axes (a stacked population): only the last four axes of a
conv weight are transposed.

The LLM families keep the reference's nested dicts and layout unchanged:
(L, …) stacked leaves (dense, ssm, audio), the hybrid family's list of
per-layer dicts, (d_in, d_out) weights that the port applies as x @ W,
client-stacked populations too (`family=` names the layout). The
HWIO↔OIHW transpose is a property of the cnn family; it applies to a
cnn tree's conv leaves and to no other family's. Optimizer states cross
as the reference holds them: SGD's {"mu", "count"}, AdamW's {"m", "v",
"count"}, moments in float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.client_state import PopulationState
from repro_torch.device import resolve_device
from repro_torch.fl.hetero import PeerStore
from repro_torch.utils.pytree import tree_map

CONV_LEAVES = ("conv", "conv1", "conv2", "proj")


def _is_conv(name: str, family: str) -> bool:
    """A cnn conv weight (named by its last component); never a leaf of
    another family, whatever its name."""
    return family == "cnn" and name.rsplit(".", 1)[-1] in CONV_LEAVES


def _hwio_to_oihw(a):
    n = a.ndim
    return np.transpose(a, tuple(range(n - 4)) + (n - 1, n - 2, n - 4, n - 3))


def _oihw_to_hwio(a):
    n = a.ndim
    return np.transpose(a, tuple(range(n - 4)) + (n - 2, n - 1, n - 3, n - 4))


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts/lists/tuples of arrays → {dotted name: array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten_tree(flat: dict) -> dict:
    """{dotted name: array} → nested tree; numeric components become
    list entries (the reference's `stages` lists)."""
    root: dict = {}
    for name, leaf in flat.items():
        node = root
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    return _listify(root)


def _listify(node):
    """Dicts keyed 0..n−1 → lists, recursively (a module-level function:
    a self-calling closure would be a reference cycle)."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def _leaf_to_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf → a CPU tensor of its dtype (copied). A bfloat16 leaf
    (the reference's arrays of a bf16 model, numpy dtype `bfloat16`)
    keeps its bits, moved through a 16-bit integer view."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_reference(np_tree, device="cuda", *,
                          family: str = "cnn") -> dict:
    """Reference params (numpy, any leading axes) → the port's params on
    `device` (arrays are copied, dtypes kept, bfloat16 included): a flat
    dict with OIHW convs for the cnn family, the reference's nested dicts
    and lists unchanged for the LLM families (the hybrid family's list of
    layer dicts, its f32 `lambda` leaves in a bf16 model). Raises if
    `device` names CUDA and there is none."""
    device = resolve_device(device)
    out = {}
    for name, leaf in flatten_tree(np_tree).items():
        a = np.asarray(leaf)
        if _is_conv(name, family):
            a = _hwio_to_oihw(a)
        out[name] = _leaf_to_tensor(a).to(device)
    return out if family == "cnn" else unflatten_tree(out)


def params_to_reference(params: dict, *, family: str = "cnn") -> dict:
    """The port's params → the reference's nested numpy tree (floating
    leaves as float32; HWIO convs for the cnn family)."""
    flat = {}
    for name, t in flatten_tree(params).items():
        t = t.detach().cpu()
        a = (t.float() if t.is_floating_point() else t).numpy()
        flat[name] = _oihw_to_hwio(a) if _is_conv(name, family) else a
    return unflatten_tree(flat)


# the moment trees of each optimizer state (SGD: mu; AdamW: m, v), the
# rest of a state being its step count
MOMENT_KEYS = ("mu", "m", "v")


def opt_from_reference(opt, device="cuda", *, family: str = "cnn") -> dict:
    """A reference SGD ({"mu", "count"}) or AdamW ({"m", "v", "count"})
    state of numpy arrays (any leading axes) → the port's on `device`,
    the moments float32 in the family's parameter layout."""
    device = resolve_device(device)
    out = {k: tree_map(lambda t: t.float(), params_from_reference(
        opt[k], device=device, family=family))
        for k in MOMENT_KEYS if k in opt}
    out["count"] = torch.from_numpy(np.array(opt["count"], np.int32)).to(
        device)
    return out


def opt_to_reference(opt, *, family: str = "cnn") -> dict:
    """The port's optimizer state → the reference's, as numpy trees."""
    out = {k: params_to_reference(opt[k], family=family)
           for k in MOMENT_KEYS if k in opt}
    out["count"] = opt["count"].cpu().numpy()
    return out


def population_from_reference(state_np, device="cuda", *,
                              family: str = "cnn") -> PopulationState:
    """A reference PopulationState whose leaves are numpy arrays (fields
    by attribute or key) → the port's PopulationState on `device`,
    including the optimizer states (SGD or AdamW), loss_matrix,
    last_selected and round; `family` names the parameters' layout (the
    cnn's flat dotted names, or an LLM's nested trees, client-stacked).
    Raises if `device` names CUDA and there is none."""
    device = resolve_device(device)
    get =(state_np.__getitem__ if isinstance(state_np, dict)
           else lambda f: getattr(state_np, f))
    kw = dict(device=device, family=family)
    return PopulationState(
        extractor=params_from_reference(get("extractor"), **kw),
        header=params_from_reference(get("header"), **kw),
        opt_e=opt_from_reference(get("opt_e"), **kw),
        opt_h=opt_from_reference(get("opt_h"), **kw),
        loss_matrix=torch.from_numpy(
            np.array(get("loss_matrix"), np.float32)).to(device),
        last_selected=torch.from_numpy(
            np.array(get("last_selected"), np.int32)).to(device),
        round=torch.from_numpy(np.array(get("round"), np.int32)),
        store=_store_from_reference(_field(state_np, "store"), device),
    )


def _field(state, name):
    return (state.get(name) if isinstance(state, dict)
            else getattr(state, name, None))


def _store_from_reference(store, device):
    """A reference PeerStore (numpy leaves; `params` {"e", "h"} with
    (V, M, ...) leaves) → the port's, or None."""
    if store is None:
        return None
    get = (store.__getitem__ if isinstance(store, dict)
           else lambda f: getattr(store, f))
    params = get("params")
    return PeerStore(
        params={k: params_from_reference(v, device=device)
                for k, v in params.items()},
        pub_round=torch.from_numpy(
            np.array(get("pub_round"), np.int32)).to(device),
        lag=torch.from_numpy(np.array(get("lag"), np.int32)).to(device))


def population_to_reference(state: PopulationState, *,
                            family: str = "cnn") -> dict:
    """The port's PopulationState → a dict of the reference's fields as
    numpy trees (reference layout); a peer store as a dict of its
    fields."""
    store = None
    if state.store is not None:
        store = {"params": {k: params_to_reference(v)
                            for k, v in state.store.params.items()},
                 "pub_round": state.store.pub_round.cpu().numpy(),
                 "lag": state.store.lag.cpu().numpy()}
    return {
        "extractor": params_to_reference(state.extractor, family=family),
        "header": params_to_reference(state.header, family=family),
        "opt_e": opt_to_reference(state.opt_e, family=family),
        "opt_h": opt_to_reference(state.opt_h, family=family),
        "loss_matrix": state.loss_matrix.cpu().numpy(),
        "last_selected": state.last_selected.cpu().numpy(),
        "round": state.round.cpu().numpy(),
        "store": store,
    }


def baseline_state_from_reference(state_np: dict, device="cuda", *,
                                  family: str = "cnn") -> dict:
    """A reference baseline state of numpy arrays — {"params", "opt"
    ({"mu", "count"}, or {"e": ...} for fedbabu), "round"[, "mask"]} —
    → the port's dict state on `device` (a cnn's masks transposed like
    the conv weights they cover); raises if `device` names CUDA and there
    is none."""
    device = resolve_device(device)
    kw = dict(device=device, family=family)
    opt = state_np["opt"]
    out = {"params": params_from_reference(state_np["params"], **kw),
           "opt": ({"e": opt_from_reference(opt["e"], **kw)}
                   if "e" in opt else opt_from_reference(opt, **kw)),
           "round": torch.from_numpy(np.array(state_np["round"], np.int32))}
    if "mask" in state_np:
        out["mask"] = params_from_reference(state_np["mask"], **kw)
    return out


def baseline_state_to_reference(state: dict, *, family: str = "cnn") -> dict:
    """The port's baseline dict state → the reference's, as numpy trees
    (reference layout)."""
    opt = state["opt"]
    out = {"params": params_to_reference(state["params"], family=family),
           "opt": ({"e": opt_to_reference(opt["e"], family=family)}
                   if "e" in opt else opt_to_reference(opt, family=family)),
           "round": state["round"].cpu().numpy()}
    if "mask" in state:
        out["mask"] = params_to_reference(state["mask"], family=family)
    return out
