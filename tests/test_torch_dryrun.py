"""The port's one-card dry run (`repro_torch.launch.dryrun`): `run_combo`
returns "ok" with every key of the reference's records for one reduced
config of each family, in both modes and for each step kind; the
reference's skip rule and reason; the CLI's flags, output file and exit
codes; and the dry run's inputs: meta structs whose bytes equal the real
inputs' built the same way on the CPU, with outputs of the real step's
shapes, and nothing allocated off the meta device during a trace.

Small shapes (`InputShape`s outside INPUT_SHAPES) keep the traces cheap;
the full-width `--all` run is the CLI's (README), and one full-width
decode combo runs here.
"""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from repro.launch import roofline as ref_roofline
from repro_torch.configs import InputShape, get_config
from repro_torch.launch import dryrun
from repro_torch.utils.pytree import tree_leaves

REF_DRYRUN = (Path(__file__).resolve().parent.parent / "src" / "repro" /
              "launch" / "dryrun.py").read_text()
# the reference's run_combo record keys beyond its report's (`:175-218`)
MEM_KEYS = ("temp_size_in_bytes", "argument_size_in_bytes",
            "output_size_in_bytes", "generated_code_size_in_bytes")
BASE_KEYS = ("arch", "shape", "mesh", "status", "t_lower_s", "t_compile_s")
FAMILY_ARCHS = {"dense": "qwen2-1.5b", "moe": "deepseek-v3-671b",
                "vlm": "internvl2-76b", "ssm": "rwkv6-7b",
                "hybrid": "recurrentgemma-2b", "audio": "whisper-base"}
SMALL = [InputShape("t", 16, 4, "train"), InputShape("p", 24, 2, "prefill"),
         InputShape("d", 24, 2, "decode")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: as fast for these small tensors, and parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_keys() -> set:
    for key in MEM_KEYS + BASE_KEYS:
        assert f'"{key}"' in REF_DRYRUN, key
    rep = ref_roofline.RooflineReport(arch="a", shape="s", mesh="m",
                                      chips=1, hlo_flops=1.0, hlo_bytes=1.0,
                                      coll_bytes=0.0)
    return set(BASE_KEYS) | set(MEM_KEYS) | set(rep.to_dict())


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_run_combo_ok_for_each_family_in_both_modes(family):
    """Reduced configs, train / prefill / decode single, and train multi
    (the fed round over FED_CLIENTS clients; the serving shapes run the
    same step in both modes, see the CLI test): status ok, the
    reference's keys, one chip, no collective, nothing compiled, FLOPs
    and bytes counted, no bytes off the meta device; the fed round counts
    more than the pair step; flash (and wkv for rwkv6) counted by their
    work in the prefill."""
    arch = FAMILY_ARCHS[family]
    cfg = get_config(arch).reduced()
    assert cfg.family == family
    keys = _reference_keys()
    for shape in SMALL:
        recs = {}
        for multi in (False, True)[:2 if shape.kind == "train" else 1]:
            rec = dryrun.run_combo(arch, shape.name, multi, verbose=False,
                                   cfg=cfg, shape=shape)
            assert rec["status"] == "ok", rec.get("error")
            assert keys <= set(rec), keys - set(rec)
            assert rec["mesh"] == ("h100x1-fed2" if multi else "h100x1")
            assert rec["chips"] == 1 and rec["t_compile_s"] == 0.0
            assert rec["coll_bytes_per_dev"] == rec["t_collective_s"] == 0.0
            assert rec["hlo_flops_per_dev"] > 0 and rec["hlo_bytes_per_dev"] > 0
            assert rec["non_meta_bytes"] == 0
            assert rec["argument_size_in_bytes"] > 0
            assert rec["temp_size_in_bytes"] > 0
            recs[multi] = rec
        if shape.kind == "train":
            assert recs[True]["hlo_flops_per_dev"] > \
                recs[False]["hlo_flops_per_dev"]
        if shape.kind == "prefill":
            calls = recs[False]["kernel_calls"]
            if family == "ssm":
                assert calls == {"wkv_chunked": cfg.num_layers}
            elif family == "hybrid":
                n_attn = sum(k != "rec" for k in cfg.block_pattern)
                assert calls == {"flash_attention": n_attn}
            elif family == "audio":
                assert calls["flash_attention"] > 0
            else:
                assert calls == {"flash_attention": cfg.num_layers}


def test_skips_long_500k_as_the_reference_and_the_cli(tmp_path, capsys):
    """long_500k is skipped with the reference's reason for a quadratic
    arch and runs for a sub-quadratic one; the CLI (full width, one
    decode combo in both modes) appends one JSON record a combo and exits
    0, and exits 1 when a combo fails."""
    rec = dryrun.run_combo("qwen2-1.5b", "long_500k", False, verbose=False)
    assert rec["status"] == "skipped"
    assert f'"{rec["reason"]}"' in REF_DRYRUN
    assert dryrun.skip_reason(get_config("rwkv6-7b"),
                              dryrun.INPUT_SHAPES["long_500k"]) is None
    out = tmp_path / "d.jsonl"
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                        "--mesh", "both", "--out", str(out),
                        "--quiet"]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["h100x1", "h100x1-fed2"]
    assert all(r["status"] == "ok" for r in recs)
    assert recs[0]["bottleneck"] == "memory"
    assert "dry-run: 2 ok, 0 skipped, 0 errors" in capsys.readouterr().out

    def broken(*a, **kw):
        raise RuntimeError("boom")

    orig, dryrun.build = dryrun.build, broken
    try:
        assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                            "--mesh", "single", "--quiet"]) == 1
    finally:
        dryrun.build = orig


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-7b"])
def test_meta_inputs_match_real_inputs(arch):
    """`build` on meta and on the CPU (real draws) gives inputs of the
    same structure, shapes, dtypes and storage bytes; the real step's
    outputs have the meta trace's shapes."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    for shape in SMALL:
        for multi in (False, True):
            fn, meta_args = dryrun.build(cfg, shape, multi)
            _, real_args = dryrun.build(cfg, shape, multi, device="cpu",
                                        seed=3)
            assert dryrun.storage_bytes(meta_args) == \
                dryrun.storage_bytes(real_args)
            m_leaves, r_leaves = (tree_leaves(list(a)) for a in
                                  (meta_args, real_args))
            assert len(m_leaves) == len(r_leaves)
            for m, r in zip(m_leaves, r_leaves):
                if isinstance(m, torch.Tensor):
                    assert m.is_meta and not r.is_meta
                    assert (m.shape, m.dtype) == (r.shape, r.dtype)
                else:
                    assert m == r
            if shape.kind == "train" and multi:
                continue          # the fed round is traced above only
            m_out = tree_leaves(list(fn(*meta_args)))
            r_out = tree_leaves(list(fn(*real_args)))
            assert [(t.shape, t.dtype) for t in m_out] == \
                [(t.shape, t.dtype) for t in r_out]
            assert all(bool(torch.isfinite(t.float()).all()) for t in r_out
                       if t.is_floating_point())
