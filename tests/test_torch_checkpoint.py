"""The port's checkpoints (`repro_torch.checkpoint`) in the reference's
on-disk format: round trips of f32, bf16, int32 and bool leaves in nested
dicts, lists and a PopulationState with a peer store; `latest_checkpoint`;
a file either package writes, read by the other bitwise by path; reduced
qwen2-1.5b and recurrentgemma-2b parameters saved by either package and
restored by the other (`load_checkpoint(like=...)`), equal to
`convert.params_from_reference`;
and `launch.serve --ckpt-dir` on the CPU. Every comparison is exact.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_checkpoint as ref_latest
from repro.checkpoint import load_checkpoint as ref_load
from repro.checkpoint import save_checkpoint as ref_save
from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.utils.pytree import tree_paths as ref_tree_paths
from repro_torch import convert
from repro_torch.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import FLConfig, get_config
from repro_torch.fl import strategies
from repro_torch.launch import serve
from repro_torch.models import model as model_mod
from repro_torch.utils.pytree import tree_leaves, tree_paths


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "layers": {"w": torch.randn(3, 4, 5, generator=g),
                   "b": torch.randn(4, generator=g).to(torch.bfloat16)},
        "head": [torch.arange(6, dtype=torch.int32).reshape(2, 3),
                 torch.tensor([True, False, True]),
                 torch.ones(())],
    }


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a.cpu(), b.cpu())


def test_roundtrip(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 7, tree, extra={"note": "x"})
    assert path.endswith("ckpt_00000007.npz")
    restored, manifest = load_checkpoint(path, like=tree, device="cpu")
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    assert manifest["dtypes"] == {"head/0": "int32", "head/1": "bool",
                                  "head/2": "float32", "layers/b": "bfloat16",
                                  "layers/w": "float32"}
    assert isinstance(restored["head"], list)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        _same(a, b)
    by_path, _ = load_checkpoint(path, device="cpu")
    assert list(by_path) == [p for p, _ in tree_paths(tree)]
    with pytest.raises(ValueError):
        load_checkpoint(path, like={"layers": tree["layers"]}, device="cpu")


def test_population_state_with_peer_store_roundtrip(tmp_path):
    """pfeddst_async's whole state (bf16 parameters, f32 momenta, the
    versioned peer store, the CPU round) restores as the same
    PopulationState, bit for bit."""
    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="bfloat16", image_size=8)
    fl = FLConfig(num_clients=3, client_sample_ratio=1.0)
    strat = strategies.make_strategy("pfeddst_async", cfg, fl, 1,
                                     device="cpu")
    state = strat.init(0)
    assert state.store is not None
    path = save_checkpoint(str(tmp_path), 3, state)
    restored, _ = load_checkpoint(path, like=state, device="cpu")
    assert type(restored) is type(state)
    assert type(restored.store) is type(state.store)
    got, want = tree_paths(restored), tree_paths(state)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        _same(a, b)


def test_latest_checkpoint(tmp_path):
    tree = {"w": torch.ones(2)}
    assert latest_checkpoint(str(tmp_path / "none")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 12, tree)
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_00000012.npz")
    assert latest_checkpoint(str(tmp_path)) == ref_latest(str(tmp_path))


def test_port_file_reads_in_the_reference_bitwise(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 2, tree)
    by_path, manifest = ref_load(path)
    assert manifest["paths"] == [p for p, _ in tree_paths(tree)]
    for p, t in tree_paths(tree):
        a = by_path[p]
        assert str(a.dtype) == str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint16),
                t.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(np.asarray(a), t.numpy())


def test_reference_file_reads_in_the_port_bitwise(tmp_path):
    key = jax.random.PRNGKey(0)
    tree = {"layers": {"w": jax.random.normal(key, (3, 4, 5)),
                       "b": jax.random.normal(key, (4,)).astype(jnp.bfloat16)},
            "head": [jnp.arange(6, dtype=jnp.int32).reshape(2, 3),
                     jnp.asarray([True, False])]}
    path = ref_save(str(tmp_path), 5, tree, extra={"from": "reference"})
    got, manifest = load_checkpoint(path, device="cpu")
    assert manifest["extra"] == {"from": "reference"}
    for p, a in ref_tree_paths(tree):
        t = got[p]
        if a.dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                np.asarray(a).view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_reference_llm_checkpoint_restores_into_port_params(tmp_path):
    """Reduced qwen2-1.5b (bf16): the reference's parameters, saved by
    the reference, restore into the port's tree (`like=` the port's own
    init) equal to `convert.params_from_reference(family="dense")`."""
    ref_cfg = ref_get_config("qwen2-1.5b").reduced()
    cfg = get_config("qwen2-1.5b").reduced()
    rparams = ref_model.init_params(ref_cfg, jax.random.PRNGKey(3))
    path = ref_save(str(tmp_path), 0, rparams)
    like = model_mod.init_params(cfg, torch.Generator().manual_seed(0),
                                 torch.device("cpu"))
    assert [p for p, _ in tree_paths(like)] == \
        [p for p, _ in ref_tree_paths(rparams)]
    got, _ = load_checkpoint(path, like=like, device="cpu")
    # convert takes numpy's own dtypes: bf16 goes over as f32 (exact)
    want = convert.params_from_reference(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), rparams),
        device="cpu", family="dense")
    assert [p for p, _ in tree_paths(got)] == [p for p, _ in
                                               tree_paths(want)]
    for (_, a), (_, b), (_, r) in zip(tree_paths(got), tree_paths(want),
                                      ref_tree_paths(rparams)):
        assert str(a.dtype).removeprefix("torch.") == str(r.dtype)
        assert torch.equal(a.float(), b)


def test_hybrid_checkpoint_round_trips_in_both_formats(tmp_path):
    """Reduced recurrentgemma-2b (bf16, with f32 `lambda` leaves, its
    layers a list of dicts): the reference's parameters saved by the
    reference restore into the port's tree bitwise and equal to
    `convert.params_from_reference` (which keeps the bf16 bits); the
    port's saved by the port restore in the reference bitwise; and
    `convert` takes the tree both ways without touching `conv_w`."""
    ref_cfg = ref_get_config("recurrentgemma-2b").reduced()
    cfg = get_config("recurrentgemma-2b").reduced()
    rparams = ref_model.init_params(ref_cfg, jax.random.PRNGKey(4))
    like = model_mod.init_params(cfg, torch.Generator().manual_seed(0),
                                 torch.device("cpu"))
    assert isinstance(like["layers"], list) and len(like["layers"]) == 3
    assert [p for p, _ in tree_paths(like)] == \
        [p for p, _ in ref_tree_paths(rparams)]
    got, _ = load_checkpoint(ref_save(str(tmp_path / "ref"), 0, rparams),
                             like=like, device="cpu")
    assert isinstance(got["layers"], list)
    assert got["layers"][0]["temporal"]["lambda"].dtype == torch.float32
    assert got["layers"][0]["temporal"]["conv_w"].dtype == torch.bfloat16
    want = convert.params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), device="cpu",
        family="hybrid")
    assert isinstance(want["layers"], list)
    for (pa, a), (pb, b) in zip(tree_paths(got), tree_paths(want)):
        assert pa == pb
        _same(a, b)
    for (p, a), (_, r) in zip(tree_paths(got), ref_tree_paths(rparams)):
        assert str(a.dtype).removeprefix("torch.") == str(r.dtype), p
        assert tuple(a.shape) == r.shape, p
    # the port's file in the reference
    back, _ = ref_load(save_checkpoint(str(tmp_path / "port"), 1, like),
                       like=rparams)
    assert isinstance(back["layers"], list)
    for (p, a), (_, t) in zip(ref_tree_paths(back), tree_paths(like)):
        assert str(a.dtype) == str(t.dtype).removeprefix("torch."), p
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint16),
                t.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(np.asarray(a), t.numpy())
    # convert back: the same list layout, conv_w (4, W) as it was
    ref_tree = convert.params_to_reference(like, family="hybrid")
    assert isinstance(ref_tree["layers"], list)
    conv_w = ref_tree["layers"][0]["temporal"]["conv_w"]
    assert conv_w.shape == (4, cfg.lru_width)
    np.testing.assert_array_equal(
        conv_w, like["layers"][0]["temporal"]["conv_w"].float().numpy())
    assert ref_tree["layers"][0]["temporal"]["lambda"].dtype == np.float32


def test_load_checkpoint_without_device_needs_cuda(tmp_path, monkeypatch):
    """The default places the leaves on the card; without one it raises
    (no silent CPU restore)."""
    path = save_checkpoint(str(tmp_path), 0, {"w": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        load_checkpoint(path)


def test_serve_restores_from_ckpt_dir(tmp_path, capsys, monkeypatch):
    """`serve --ckpt-dir` restores the latest checkpoint (another seed's
    parameters) and serves with them: the same greedy tokens as serving
    those parameters directly."""
    cfg = get_config("qwen2-1.5b").reduced()
    other = model_mod.init_params(cfg, torch.Generator().manual_seed(7),
                                  torch.device("cpu"))
    save_checkpoint(str(tmp_path), 4, other)
    args = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "4"]
    got = serve.main(args + ["--ckpt-dir", str(tmp_path)])
    assert f"restored {tmp_path}/ckpt_00000004.npz" in capsys.readouterr().out
    real = model_mod.init_params
    monkeypatch.setattr(serve.model_mod, "init_params",
                        lambda c, g, d: real(
                            c, torch.Generator().manual_seed(7), d))
    want = serve.main(args)
    assert torch.equal(got, want)
    monkeypatch.undo()
    plain = serve.main(args + ["--ckpt-dir", str(tmp_path / "empty")])
    assert "restored" not in capsys.readouterr().out
    assert plain.shape == got.shape
    json.dumps(plain.tolist())
