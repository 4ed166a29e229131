"""The port's dry-run inputs and layouts against the JAX reference:
`INPUT_SHAPES` and `ASSIGNED_ARCHS`, the meta-tensor structs (params,
optimizer state, batches, caches) against `jax.eval_shape`'s shapes and
dtypes leaf by leaf, and the sharding specs (param, opt, batch, cache) as
tuples against the reference's `PartitionSpec`s for every leaf and every
assigned arch at full width, on the (16, 16) mesh and on the (2, 16, 16)
one with the pod merged into data and into model. Also the mesh objects,
`MeshAxes.from_mesh`, the spec helpers, `utils.hw` and `utils.prng`.

No real parameter is drawn on either side: the reference traces
`init_params` abstractly, the port builds meta tensors.
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ASSIGNED_ARCHS as REF_ARCHS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro.optim.sgd import sgd as ref_sgd
from repro.utils import sharding as ref_sharding
from repro.utils.pytree import tree_paths as ref_tree_paths
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.optim.sgd import sgd
from repro_torch.utils import hw, sharding
from repro_torch.utils.prng import KeySeq
from repro_torch.utils.pytree import tree_paths

OPT = dict(lr=0.1, momentum=0.9, weight_decay=0.005)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: as fast for these small tensors, and parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake_ref_mesh(shape, names):
    """What the reference's `MeshAxes.from_mesh` reads of a jax Mesh
    (512 placeholder devices cannot be made in a test process)."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# (mesh, pod_merge): the single pod, and the pod merged into data (the
# serving scale-out) and into model (long_500k)
AXES_CASES = [("16x16", "data"), ("2x16x16", "data"), ("2x16x16", "model")]


def _axes(mesh_key, merge):
    shape, names = MESHES[mesh_key]
    ours = sharding.MeshAxes.from_mesh(mesh_mod.Mesh(shape, names),
                                       pod_merge=merge)
    theirs = ref_sharding.MeshAxes.from_mesh(_fake_ref_mesh(shape, names),
                                             pod_merge=merge)
    return ours, theirs


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _structs(ours, theirs):
    """[(path, shape, dtype)] of both trees, in path order."""
    a = [(p, tuple(x.shape), _dtype(x)) for p, x in tree_paths(ours)]
    b = [(p, tuple(x.shape), str(x.dtype)) for p, x in ref_tree_paths(theirs)]
    return sorted(a), sorted(b)


def _spec_paths(tree, path=()):
    """[(path, spec)] of a port spec tree (a tuple is a spec)."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree)
                for e in _spec_paths(tree[k], path + (str(k),))]
    if isinstance(tree, list):
        return [e for i, v in enumerate(tree)
                for e in _spec_paths(v, path + (str(i),))]
    assert isinstance(tree, tuple), type(tree)
    return [("/".join(path), tree)]


def _ref_spec_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    out = []
    for path, spec in flat:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out.append(("/".join(keys), tuple(spec)))
    return sorted(out)


def _same_specs(ours, theirs):
    a, b = sorted(_spec_paths(ours)), _ref_spec_paths(theirs)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, sa), (_, sb) in zip(a, b):
        assert sa == sb, (path, sa, sb)
    return len(a)


def test_input_shapes_and_assigned_archs_equal_reference():
    assert ASSIGNED_ARCHS == REF_ARCHS
    assert list(INPUT_SHAPES) == list(REF_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        ref = REF_SHAPES[name]
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) \
            == (ref.name, ref.seq_len, ref.global_batch, ref.kind)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_structs_and_specs_equal_reference(arch):
    """At full width: params, SGD state, the train batch and the decode
    caches (decode_32k; long_500k for the sub-quadratic archs) equal the
    reference's eval_shape structs leaf by leaf (path, shape, dtype), on
    the meta device; every spec equals the reference's on the three axes
    views."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    params, rparams = specs.param_structs(cfg), ref_specs.param_structs(rcfg)
    assert all(x.is_meta for _, x in tree_paths(params))
    a, b = _structs(params, rparams)
    assert a == b
    opt, ropt = (specs.opt_structs(sgd(**OPT), params),
                 ref_specs.opt_structs(ref_sgd(**OPT), rparams))
    assert _structs(opt, ropt)[0] == _structs(opt, ropt)[1]
    shape = INPUT_SHAPES["train_4k"]
    batch = specs.batch_structs(cfg, shape.global_batch, shape.seq_len)
    rbatch = ref_specs.batch_structs(rcfg, shape.global_batch,
                                     shape.seq_len)
    assert _structs(batch, rbatch)[0] == _structs(batch, rbatch)[1]
    decode = ["decode_32k"] + (["long_500k"] if cfg.sub_quadratic else [])
    caches = {}
    for name in decode:
        s = INPUT_SHAPES[name]
        caches[name] = (specs.cache_structs(cfg, s.global_batch, s.seq_len),
                        ref_specs.cache_structs(rcfg, s.global_batch,
                                                s.seq_len))
        assert _structs(*caches[name])[0] == _structs(*caches[name])[1]

    n = 0
    for mesh_key, merge in AXES_CASES:
        axes, raxes = _axes(mesh_key, merge)
        n += _same_specs(specs.param_specs(cfg, params, axes),
                         ref_specs.param_specs(rcfg, rparams, raxes))
        n += _same_specs(specs.opt_specs(cfg, opt, axes),
                         ref_specs.opt_specs(rcfg, ropt, raxes))
        n += _same_specs(specs.batch_specs(cfg, batch, axes),
                         ref_specs.batch_specs(rcfg, rbatch, raxes))
        for name, (c, rc) in caches.items():
            s = INPUT_SHAPES[name]
            n += _same_specs(specs.cache_specs(cfg, c, axes, s.seq_len),
                             ref_specs.cache_specs(rcfg, rc, raxes,
                                                   s.seq_len))
    assert n > 0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-7b"])
def test_input_specs_equal_reference(arch):
    """`input_specs` of every shape kind: the same keys and structs (the
    decode position a 0-d int32)."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        ours = specs.input_specs(cfg, name)
        theirs = ref_specs.input_specs(rcfg, name)
        assert set(ours) == set(theirs)
        for key in ours:
            a, b = _structs(ours[key], theirs[key])
            assert a == b, (name, key)


def test_axes_views_and_spec_helpers_equal_reference():
    """MeshAxes.from_mesh on every mesh and merge, axes_for's merge policy,
    batch_spec, add_leading, tree_add_leading and _flat against the
    reference's (PartitionSpecs as tuples)."""
    for mesh_key, merge in AXES_CASES + [("16x16", "model")]:
        ours, theirs = _axes(mesh_key, merge)
        assert (ours.data, ours.model, ours.data_name, ours.model_name) == \
            (theirs.data, theirs.model, theirs.data_name, theirs.model_name)
    mesh = mesh_mod.make_production_mesh(multi_pod=True)
    rmesh = _fake_ref_mesh(mesh.axis_sizes, mesh.axis_names)
    for name, shape in INPUT_SHAPES.items():
        a = specs.axes_for(mesh, shape)
        b = ref_specs.axes_for(rmesh, REF_SHAPES[name])
        assert (a.data, a.model, a.data_name, a.model_name) == \
            (b.data, b.model, b.data_name, b.model_name)
    for nd in (1, 2, 4):
        for axes in (("data",), ("pod", "data")):
            assert sharding.batch_spec(nd, axes) == \
                tuple(ref_sharding.batch_spec(nd, axes))
    assert sharding.add_leading(("model", None), "pod") == \
        tuple(ref_sharding.add_leading(P("model", None), "pod"))
    tree = {"a": ("data", None), "b": [(None,), (("pod", "data"), "model")]}
    rtree = {"a": P("data", None), "b": [P(None), P(("pod", "data"),
                                                     "model")]}
    assert _same_specs(sharding.tree_add_leading(tree, "pod"),
                       ref_sharding.tree_add_leading(rtree, "pod")) == 3
    for names in ((None,), ("data",), (("pod", "data"), "model"),
                  (None, "model")):
        assert sharding._flat(*names) == ref_sharding._flat(*names)


def test_meshes_carry_the_reference_shapes_and_place_nothing():
    single = mesh_mod.make_production_mesh()
    multi = mesh_mod.make_production_mesh(multi_pod=True)
    assert (single.axis_sizes, single.axis_names) == ((16, 16),
                                                       ("data", "model"))
    assert (multi.axis_sizes, multi.axis_names) == (
        (2, 16, 16), ("pod", "data", "model"))
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh_mod.mesh_num_devices(single) == 256
    assert mesh_mod.mesh_num_devices(multi) == 512
    host = mesh_mod.make_host_mesh()
    assert host.axis_names == ("data", "model")
    assert mesh_mod.mesh_num_devices(host) == max(torch.cuda.device_count(),
                                                  1)


def test_chip_spec_and_tile_constants():
    chip = hw.H100_SXM
    assert (chip.peak_flops_fp32, chip.peak_flops_bf16, chip.peak_flops_tf32,
            chip.hbm_bandwidth) == (67e12, 989e12, 495e12, 3.35e12)
    assert 80e9 <= chip.hbm_bytes <= 80 * 2**30
    assert (hw.WARP, hw.WGMMA_M, hw.NUM_SMS, hw.SMEM_PER_SM) == \
        (32, 64, 132, 228 * 1024)


def test_key_seq_is_deterministic_and_streams_independent():
    """Equal seeds give equal generators; next() and take(n) give fresh,
    pairwise different streams; a SeedSequence is accepted."""
    a, b = KeySeq(7), KeySeq(np.random.SeedSequence(7))
    draws_a = [torch.randn(64, generator=g) for g in [next(a), next(a)]
               + a.take(3)]
    draws_b = [torch.randn(64, generator=g) for g in [next(b), next(b)]
               + b.take(3)]
    for x, y in zip(draws_a, draws_b):
        assert torch.equal(x, y)
    for i in range(len(draws_a)):
        for j in range(i + 1, len(draws_a)):
            assert not torch.equal(draws_a[i], draws_a[j])
            assert abs(float(torch.corrcoef(torch.stack(
                [draws_a[i], draws_a[j]]))[0, 1])) < 0.5
    assert all(isinstance(g, torch.Generator) and g.device.type == "cpu"
               for g in KeySeq(1).take(2))
    assert not torch.equal(torch.randn(8, generator=next(KeySeq(1))),
                           torch.randn(8, generator=next(KeySeq(2))))
