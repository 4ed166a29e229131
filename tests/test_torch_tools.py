"""The port's twins of `examples/serve_demo.py` and `tools/trace_report.py`
against the reference's.

serve_demo: its greedy tokens equal the reference's `launch.serve.generate`
on the reference's weights (`convert`ed) and the same prompts, for a dense
and a recurrent arch (reduced, float32: the port's f32 logits differ from
the reference's by ~1e-6, see tests/test_torch_serve.py); its CLI prints
the reference's line per arch. trace_report: on a trace the port's
`run_experiment(trace=)` wrote at tiny size, its text equals the
reference tool's (loaded by path, as tests/test_obs.py does), and the
`--validate` exit codes and messages match on the file and on a
corrupted copy.
"""
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.serve import generate as ref_generate
from repro.models import model as ref_model
from repro_torch import convert
from repro_torch.configs import FLConfig, get_config
from repro_torch.data.synthetic import client_datasets_cifar
from repro_torch.examples import serve_demo
from repro_torch.fl import simulator
from repro_torch.tools import trace_report

from test_torch_support import to_numpy

ROOT = Path(__file__).resolve().parent.parent
BATCH, PROMPT, GEN = 4, 16, 8          # the demo's defaults


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: as fast for these small tensors, and parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "ref_trace_report", ROOT / "tools" / "trace_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-7b"])
def test_serve_demo_tokens_equal_reference_generate(arch):
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    rparams = jax.jit(lambda k: ref_model.init_params(rcfg, k))(
        jax.random.PRNGKey(0))
    params = convert.params_from_reference(to_numpy(rparams), device="cpu",
                                           family=cfg.family)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t: ref_generate(
        rcfg, p, t, gen_tokens=GEN))(rparams, jnp.asarray(prompts)))
    got, secs = serve_demo.serve_arch(cfg, params, torch.from_numpy(prompts),
                                      GEN, device="cpu")
    assert secs > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_demo_cli_prints_the_reference_line(capsys):
    """The CLI on the CPU: one line per arch in the reference's format,
    tokens equal to `serve_arch` on `make_inputs`' weights and prompts;
    the default archs are the reference's."""
    ref_src = (ROOT / "examples" / "serve_demo.py").read_text()
    for arch in serve_demo.DEFAULT_ARCHS:
        assert f'"{arch}"' in ref_src
    out = serve_demo.main(["--archs", "qwen2-1.5b", "rwkv6-7b", "--device",
                           "cpu", "--gen", "3", "--seed", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    for line, (arch, fam) in zip(lines, [("qwen2-1.5b", "dense"),
                                         ("rwkv6-7b", "ssm")]):
        assert re.fullmatch(
            rf"{re.escape(arch)} +\[{fam} *\] 12 tokens in +\d+\.\ds  "
            r"sample=\[\d+, \d+, \d+, \d+\]", line), line
        cfg = get_config(arch).reduced()
        params, prompts = serve_demo.make_inputs(cfg, 4, 16, 1)
        toks, _ = serve_demo.serve_arch(cfg, params, prompts, 3, "cpu")
        assert torch.equal(out[arch], toks)
        assert out[arch].shape == (4, 19)
        assert line.endswith(f"sample={toks[0, -4:].tolist()}")


@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    """A pfeddst run of the port (reduced CNN, 4 clients, 3 rounds) with
    the stage profile and the selected edges traced."""
    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=8)
    data = client_datasets_cifar(0, 4, samples_per_class=4, image_size=8)
    fl = FLConfig(num_clients=4, peers_per_round=1, batch_size=4,
                  client_sample_ratio=1.0, epochs_extractor=1,
                  epochs_header=1, probe_size=2)
    path = tmp_path_factory.mktemp("trace") / "t.jsonl"
    simulator.run_experiment("pfeddst", cfg, fl, data, num_rounds=3,
                             eval_every=2, steps_per_epoch=1, verbose=False,
                             device="cpu", trace=str(path),
                             trace_stages=True, trace_edges=True)
    return path


def _main_output(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_trace_report_text_and_validate_equal_reference(port_trace, tmp_path,
                                                        capsys):
    ref = _reference_tool()
    records = [json.loads(line) for line in
               port_trace.read_text().splitlines()]
    kinds = {r["type"] for r in records}
    assert {"header", "stage_profile", "round", "selection_graph",
            "summary"} <= kinds
    text = trace_report.report(records)
    assert text == ref.report(records)
    for section in ("trace: strategy=pfeddst", "per-stage wall",
                    "rounds (c = compile round)", "Eq. 9 decomposition",
                    "selection graph:", "summary:"):
        assert section in text
    for argv in ([str(port_trace)], [str(port_trace), "--validate"]):
        ours = _main_output(trace_report.main, argv, capsys)
        theirs = _main_output(ref.main, argv, capsys)
        assert ours == theirs and ours[0] == 0
    bad = tmp_path / "bad.jsonl"
    lines = port_trace.read_text().splitlines()
    bad.write_text("\n".join(lines[1:2] + lines[:1] + lines[2:]) + "\n")
    for argv in ([str(bad)], [str(bad), "--validate"]):
        ours = _main_output(trace_report.main, argv, capsys)
        theirs = _main_output(ref.main, argv, capsys)
        assert ours == theirs
    assert ours[0] == 1 and "SCHEMA ERROR" in ours[2]


def test_trace_report_imports_neither_the_obs_package_nor_torch():
    """The twin loads obs/trace.py by its path: run in a fresh
    interpreter, it leaves `repro_torch.obs` and torch unimported."""
    code = ("import sys; import repro_torch.tools.trace_report as t; "
            "print('repro_torch.obs' in sys.modules, 'torch' in sys.modules,"
            " t.SCORE_KEYS)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.stdout.split()[:2] == ["False", "False"]
