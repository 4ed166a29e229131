"""The port's roofline (`repro_torch.launch.roofline`) against the JAX
reference's and against arithmetic: `model_flops_for` exactly equal for
every arch × shape, the op counter's FLOPs / bytes / views / peak-live
accounting on known programs, the kernels counted by their work on meta
tensors, the report's terms and keys, the remat recompute counted, and
a reduced dense prefill's count equal to the analytic count from the
config, printed beside the reference's `analyze_hlo` of the same step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import roofline as ref_roofline
from repro.launch import steps as ref_steps
from repro.launch.specs import batch_structs as ref_batch_structs
from repro.launch.specs import param_structs as ref_param_structs
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, InputShape
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.roofline import OpCounter, RooflineReport
from repro_torch.utils.hw import H100_SXM


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: as fast for these small tensors, and parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_for_equals_reference(arch):
    for name, shape in INPUT_SHAPES.items():
        assert roofline.model_flops_for(get_config(arch), shape) == \
            ref_roofline.model_flops_for(ref_get_config(arch),
                                         REF_SHAPES[name])


def test_counter_matmul_views_and_peak_live():
    """mm: 2·M·N·K FLOPs (f32 at the FFMA peak, bf16 at the tensor peak),
    operands plus output in bytes; views count zero bytes and allocate
    nothing; an expanded operand counts its distinct elements; the peak
    of live created storages rises with each output and falls as they
    die."""
    m, k, n = 128, 256, 64
    a, b = _meta(m, k), _meta(k, n)
    with OpCounter() as c:
        out = a @ b
    assert c.flops_by_peak["fp32"] == 2 * m * n * k and c.flops == 2 * m * n * k
    assert c.bytes == (m * k + k * n + m * n) * 4
    assert c.peak_live_bytes == m * n * 4
    with OpCounter() as c:
        a.to(torch.bfloat16) @ b.to(torch.bfloat16)
    assert c.flops_by_peak["bf16"] == 2 * m * n * k
    with OpCounter() as c:
        for v in (out.view(-1), out.t(), out.permute(1, 0), out[3:],
                  out[0], out.unsqueeze(0), out.transpose(0, 1),
                  out.expand(2, m, n), out.detach(), out.reshape(n, m)):
            assert v.untyped_storage()._cdata == \
                out.untyped_storage()._cdata
    assert c.bytes == 0 and c.flops == 0 and c.peak_live_bytes == 0
    bias = _meta(n)
    with OpCounter() as c:
        out + bias.expand(m, n)                  # bias read once
    assert c.bytes == (2 * m * n + n) * 4
    with OpCounter() as c:
        x = _meta(1024)                          # an allocation, no traffic
        y = x + 1.0
        del x
        z = y * 2.0
        del y
    assert c.bytes == 2 * 2 * 1024 * 4
    assert c.peak_live_bytes == 2 * 1024 * 4 and c.live_bytes == 1024 * 4
    assert z.is_meta
    with OpCounter() as c:
        torch.bmm(_meta(3, m, k), _meta(3, k, n))
        torch.addmm(bias, a, b)
        out.copy_(out + 1.0)                     # copy_ reads its source
    assert c.flops == 3 * 2 * m * n * k + 2 * m * n * k
    assert c.bytes == ((3 * (m * k + k * n + m * n)) + (n + m * k + k * n
                       + m * n) + 2 * m * n + 2 * m * n) * 4


def test_counter_gathers_count_the_rows_moved():
    """An embedding lookup reads the rows it gathers, not its table."""
    table = _meta(50_000, 64)
    idx = _meta(8, dtype=torch.int64)
    with OpCounter() as c:
        table[idx]
    assert c.bytes == 2 * 8 * 64 * 4 + 8 * 8


@pytest.mark.parametrize("dtype,peak", [(torch.bfloat16, "bf16"),
                                        (torch.float32, "fp32")])
def test_kernels_on_meta_are_counted_by_their_work(dtype, peak):
    """ops.flash_attention and ops.wkv on meta tensors return the kernels'
    output shapes, run no plain version (no GEMM, no S² scores) and count
    the kernels' FLOPs and bytes (the formulas of chip_smoke.py's
    bounds); off the meta device nothing is reported."""
    b, s, h, kh, hd = 2, 300, 4, 2, 64
    q, k, v = (_meta(b, s, n, hd, dtype=dtype) for n in (h, kh, kh))
    with OpCounter() as c:
        out = ops.flash_attention(q, k, v, causal=True, window=100)
    assert out.shape == (b, s, h, hd) and out.dtype == dtype
    pairs = roofline.visible_pairs(s, s, causal=True, window=100,
                                   q_offset=0)
    assert pairs == sum(min(i + 1, 100) for i in range(s))
    assert c.flops_by_peak[peak] == 2.0 * b * h * (hd + hd) * pairs
    assert c.flops == c.flops_by_peak[peak]
    assert c.bytes == (2 * b * s * h * hd + 2 * b * s * kh * hd) * \
        q.element_size()
    assert c.kernel_calls == {"flash_attention": 1}

    r, kk, vv = (_meta(b, s, h, hd, dtype=dtype) for _ in range(3))
    w, u = _meta(b, s, h, hd), _meta(h, hd)
    with OpCounter() as c:
        out, state = ops.wkv(r, kk, vv, w, u, None)
    assert out.shape == r.shape and state.shape == (b, h, hd, hd)
    assert c.flops_by_peak["tf32"] == b * s * h * (5 * hd * hd + 5 * hd)
    assert c.bytes == roofline.wkv_work(b, s, h, hd, r.element_size(),
                                        state=False)[1]
    seen = []
    ops.META_OBSERVERS.append(lambda *a, **kw: seen.append(a[0]))
    try:
        ops.flash_attention(*(torch.zeros(1, 4, 1, 8) for _ in range(3)))
    finally:
        ops.META_OBSERVERS.pop()
    assert seen == []


def test_report_terms_and_keys():
    """The terms on the H100's peaks, per peak class; the bottleneck; and
    every key of the reference's report."""
    rep = RooflineReport(arch="x", shape="train_4k", mesh="h100x1", chips=1,
                         hlo_flops=989e12 + 67e12, hlo_bytes=3.35e12 * 0.5,
                         flops_by_peak={"bf16": 989e12, "fp32": 67e12})
    assert rep.t_compute == pytest.approx(2.0)
    assert rep.t_memory == pytest.approx(0.5)
    assert rep.t_collective == 0.0 and rep.bottleneck == "compute"
    ref = ref_roofline.RooflineReport(arch="x", shape="train_4k", mesh="m",
                                      chips=256, hlo_flops=1.0, hlo_bytes=1.0,
                                      coll_bytes=0.0)
    assert set(ref.to_dict()) <= set(rep.to_dict())
    assert rep.to_dict()["coll_detail"].keys() == \
        ref_roofline.analyze_hlo("ENTRY %e () -> f32[] {\n}\n")["coll"].keys()
    assert RooflineReport(arch="x", shape="s", mesh="m", chips=1,
                          hlo_flops=989e12, hlo_bytes=0.0).t_compute == \
        pytest.approx(1.0)
    assert H100_SXM.peak_flops_bf16 == 989e12


def _dense_prefill_flops(cfg, b, s):
    """GEMMs of a dense prefill from the config: the q/k/v/o projections,
    the gated MLP and the padded-vocabulary head, plus flash's work over
    the S(S+1)/2 causal pairs."""
    t = b * s
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    qo = 2 * 2 * t * d * cfg.num_heads * hd
    kv = 2 * 2 * t * d * cfg.num_kv_heads * hd
    mlp = 3 * 2 * t * d * f
    attn = 2 * b * cfg.num_heads * 2 * hd * (s * (s + 1) // 2)
    return cfg.num_layers * (qo + kv + mlp + attn) + \
        2 * t * d * cfg.padded_vocab


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "starcoder2-7b"])
def test_dense_prefill_count_equals_analytic_and_reference(arch):
    """A reduced dense prefill (B=2, S=96, bf16): the counter's FLOPs equal
    the analytic count exactly. The reference's `analyze_hlo` of the same
    step (chunked backend) is printed beside it: it is larger by exactly
    the masked half of its one 96×96 attention block per layer — the
    reference's chunked attention computes every block inside the causal
    band in full, flash counts only the visible pairs — within 1e-6."""
    b, s = 2, 96
    cfg, rcfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    shape = InputShape("p", s, b, "prefill")
    rec = dryrun.run_combo(arch, "p", False, verbose=False, cfg=cfg,
                           shape=shape)
    assert rec["status"] == "ok" and rec["kernel_calls"] == {
        "flash_attention": cfg.num_layers}
    want = _dense_prefill_flops(cfg, b, s)
    assert rec["hlo_flops_per_dev"] == want
    assert rec["flops_by_peak"] == {"bf16": want}

    fn = ref_steps.make_prefill_step(rcfg, s)
    compiled = jax.jit(fn).lower(ref_param_structs(rcfg),
                                 ref_batch_structs(rcfg, b, s)).compile()
    ref = ref_roofline.analyze_hlo(compiled.as_text())["flops"]
    masked = cfg.num_layers * 2 * b * cfg.num_heads * 2 * cfg.head_dim * \
        (s * s - s * (s + 1) // 2)
    print(f"{arch} reduced prefill {b}x{s}: port {want:.6e} FLOPs, "
          f"reference analyze_hlo {ref:.6e}, masked half of the chunked "
          f"blocks {masked:.6e}")
    assert ref == pytest.approx(want + masked, rel=1e-6)


def test_remat_recompute_is_counted():
    """The pair step with remat counts each layer's forward once more than
    without (the checkpoint's recompute), so its FLOPs are larger and the
    useful-FLOPs ratio smaller."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              dtype="float32")
    shape = InputShape("t", 32, 4, "train")
    recs = {}
    for remat in (False, True):
        fn, args = dryrun.build(cfg, shape, False)
        if not remat:
            from repro_torch.launch.steps import make_train_pair_step
            from repro_torch.optim.sgd import sgd
            opt = sgd(0.1, momentum=0.9, weight_decay=0.005)
            fn = make_train_pair_step(cfg, opt, opt, remat=False)
        recs[remat] = dryrun.count_step(fn, args)["counter"]
    assert recs[True].flops > recs[False].flops
    assert recs[True].bytes > recs[False].bytes
    assert recs[True].non_meta_bytes == 0
    ratio = {r: roofline.model_flops_for(cfg, shape) / recs[r].flops
             for r in recs}
    assert ratio[True] < ratio[False]
