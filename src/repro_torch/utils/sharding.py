"""Sharding rule engine (reference `repro.utils.sharding`): the reference's
layout policy for its TPU meshes, as pure functions of paths and shapes.

Baseline policy (the reference's):

* TP on the "model" axis over d_ff / flat-head / vocab / expert dims,
* FSDP on the "data" axis over d_model dims of large 2D+ weights,
* batch on the "data" axis (activations),
* a leading client axis (FL population or per-pod client) on "pod".

Every rule checks divisibility against the mesh axis size and falls back
to replication. A spec is a plain tuple, one entry per dim: None, an
axis name, or a tuple of names (a meta-axis), in the positions of the
reference's `PartitionSpec`; `P()` is `()`.

Not ported: `named`, `constrain`, `set_axis_ctx`, `clear_axis_ctx`,
`constrain_act` and `_COLLECTIVE_RE`. They place arrays and activations
on a jax mesh; the port runs in one process on one device, and the
reference's `constrain_act` is the identity without a mesh (the port's
models drop it: `models/transformer.py`, `models/moe.py`). The specs
here are what the dry run reports a layout with (`launch/specs.py`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.utils.pytree import tree_map, tree_unflatten_paths


def _div(n: int, d: int) -> bool:
    return d > 0 and n % d == 0


def _flat(*names):
    """Flatten possibly-tuple axis names into one spec entry."""
    out = []
    for n in names:
        if n is None:
            continue
        if isinstance(n, tuple):
            out.extend(n)
        else:
            out.append(n)
    if not out:
        return None
    return out[0] if len(out) == 1 else tuple(out)


def is_spec(x) -> bool:
    """A spec (a tuple) is a leaf of a spec tree."""
    return isinstance(x, tuple)


def tree_map_with_path_str(fn, tree):
    """tree_map where fn receives ('/'-joined path, leaf), the paths of
    the reference's `tree_map_with_path_str`."""
    return tree_unflatten_paths(tree, fn)


@dataclass(frozen=True)
class MeshAxes:
    """Axis names + sizes of the active mesh (data/model required).

    Names may be tuples of mesh axes (meta-axes): on the multi-pod mesh the
    "pod" axis merges into data (serving scale-out) or model (long-context
    state sharding) — `from_mesh(pod_merge=...)` builds the right view.
    """

    data: int
    model: int
    data_name: str | tuple = "data"
    model_name: str | tuple = "model"

    @classmethod
    def from_mesh(cls, mesh, *, pod_merge: str = "data") -> "MeshAxes":
        """`mesh`: a `launch.mesh.Mesh` (axis sizes and names)."""
        sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
        data, model = sizes.get("data", 1), sizes.get("model", 1)
        data_name, model_name = "data", "model"
        pod = sizes.get("pod", 1)
        if pod > 1 and pod_merge == "data":
            data, data_name = data * pod, ("pod", "data")
        elif pod > 1 and pod_merge == "model":
            model, model_name = model * pod, ("pod", "model")
        return cls(
            data=data, model=model, data_name=data_name, model_name=model_name
        )


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

@dataclass
class ShardingRules:
    """Path-pattern → spec policy with divisibility fallbacks."""

    axes: MeshAxes

    # -- helpers ----------------------------------------------------------
    def _m(self, n: int) -> Optional[str]:
        return self.axes.model_name if _div(n, self.axes.model) else None

    def _d(self, n: int) -> Optional[str]:
        """FSDP: the data axis where it divides (the reference's `fsdp`
        switch is always on and has no caller to turn it off)."""
        return self.axes.data_name if _div(n, self.axes.data) else None

    # -- main entry -------------------------------------------------------
    def param_spec(self, path: str, shape) -> tuple:
        """Spec for one parameter given its '/'-joined path."""
        ndim = len(shape)
        p = path.lower()
        # the leading stacked-layer dim is never sharded
        stacked = "layers/" in p or p.startswith("layers")
        off = 1 if (stacked and ndim >= 2) else 0

        def build(*core):
            core = list(core) + [None] * (ndim - off - len(core))
            return tuple([None] * off + core[: ndim - off])

        # ---- norms / scalars / small vectors: replicate
        if ndim - off <= 1 or "norm" in p or "ln" in p.split("/")[-1][:2]:
            return (None,) * ndim

        # ---- embedding (V, D): vocab on model (unconditionally: a padded
        # shard), d_model FSDP on data
        if "embed" in p and ndim - off == 2:
            return build(self.axes.model_name, self._d(shape[off + 1]))

        # ---- lm head (D, V)
        if ("lm_head" in p or "head/w" in p) and ndim - off == 2:
            return build(self._d(shape[off]), self.axes.model_name)

        # ---- MoE experts (E, din, dout) after an optional layer dim:
        # expert-parallel on 'model', FSDP the din dim on 'data'
        if "experts" in p and ndim - off == 3:
            e, din = shape[off], shape[off + 1]
            return build(self._m(e), self._d(din), None)

        # ---- router (D, E): replicate E (small), FSDP D
        if "router" in p and ndim - off == 2:
            return build(self._d(shape[off]), None)

        # ---- conv kernels (kh, kw, cin, cout): shard cout on model
        if "conv" in p and ndim - off == 4:
            return build(None, None, None, self._m(shape[off + 3]))

        # ---- output projections: (dout_flat, D) — TP input, FSDP output
        last = p.split("/")[-1]
        if last in ("wo", "w_o", "out_proj", "proj_out", "wo2"):
            return build(self._m(shape[off]), self._d(shape[off + 1]))

        # ---- generic input projections (D, dout): FSDP input, TP output
        if ndim - off == 2:
            return build(self._d(shape[off]), self._m(shape[off + 1]))

        # ---- anything else: replicate
        return (None,) * ndim

    def tree_param_specs(self, params):
        """Tree of specs mirroring `params` (tensors, meta or real)."""
        return tree_map_with_path_str(
            lambda path, leaf: self.param_spec(path, tuple(leaf.shape)),
            params)


# ---------------------------------------------------------------------------
# Activation / batch specs
# ---------------------------------------------------------------------------

def batch_spec(ndim: int, data_axes=("data",)) -> tuple:
    """Batch-leading activation spec: batch over data axis, rest replicated."""
    ax = data_axes[0] if len(data_axes) == 1 else tuple(data_axes)
    return tuple([ax] + [None] * (ndim - 1))


def add_leading(spec: tuple, axis: Optional[str]) -> tuple:
    """Prepend one axis (e.g. a stacked client dim on 'pod') to a spec."""
    return (axis,) + tuple(spec)


def tree_add_leading(specs, axis: Optional[str]):
    return tree_map(lambda s: add_leading(s, axis), specs, is_leaf=is_spec)
