"""LLM training in the port against the JAX reference, at every family's
reduced config in float32: logits, `loss_fn`'s total and metrics (the
MoE aux terms included), one phase-e and one phase-h SGD step
(`core.partial_freeze`), remat against no remat, AdamW and the three
schedules, and rwkv's chunked WKV (`wkv_chunked_torch` against the
reference's `wkv_chunked_jax`).

Both packages start from the same parameters: the port draws them and
`convert.params_to_reference` hands them over as numpy. Each family's
reference results come from one jitted function, compiled at XLA's
lowest optimisation level, the families on a few threads, to keep the
file quick (the values are the same computation; the tolerances below
hold them).
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.partial_freeze import make_phase_steps as ref_phase_steps
from repro.models import model as ref_model
from repro.models import rwkv as ref_rwkv
from repro.models.split import split_params as ref_split
from repro.optim import adam as ref_adam
from repro.optim import schedules as ref_schedules
from repro.optim.base import apply_updates as ref_apply
from repro.optim.sgd import sgd as ref_sgd
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.partial_freeze import make_phase_steps
from repro_torch.models import model, rwkv
from repro_torch.models.split import split_params
from repro_torch.optim import schedules
from repro_torch.optim.adam import adamw
from repro_torch.optim.base import apply_updates
from repro_torch.optim.sgd import sgd
from repro_torch.utils.pytree import tree_leaves, tree_map

from test_torch_support import close_to_scale

ARCHS = ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
         "internvl2-76b", "rwkv6-7b", "recurrentgemma-2b", "whisper-base"]
B, S, PREFIX = 2, 12, 3
LR, MOM, WD = 0.05, 0.9, 0.005
LOGIT_TOL, LOSS_TOL, STEP_TOL = 1e-5, 1e-5, 1e-4
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: as fast for these small tensors, parallel test
    workers do not oversubscribe the cores, and the CPU's embedding
    backward (a parallel index_add) sums in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_jit(fn, *args):
    """fn(*args) jitted, compiled at XLA's lowest optimisation level."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def _cfgs(arch):
    return (dataclasses.replace(ref_get_config(arch).reduced(),
                                dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = rng.normal(
            size=(B, PREFIX, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _family_setup(arch):
    """One reduced model in both packages (the port's parameters), a
    batch, and the reference's logits, phase steps and their metrics
    (`loss_fn`'s at the same parameters) from one jitted call."""
    rcfg, cfg = _cfgs(arch)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rparams = convert.params_to_reference(params, family=cfg.family)
    batch = _batch(cfg)
    ropt = ref_sgd(LR, momentum=MOM, weight_decay=WD)
    rsteps = ref_phase_steps(rcfg, ropt)

    def reference(p, b):
        e, h = ref_split(rcfg, p)
        logits, _ = ref_model.forward(rcfg, p, b)
        e2, oe, met = rsteps.phase_e(e, h, ropt.init(e), b)
        h2, oh, _ = rsteps.phase_h(e, h, ropt.init(h), b)
        return logits, met, e2, oe["mu"], h2, oh["mu"]

    want = jax.block_until_ready(run_jit(reference, rparams, batch))
    return dict(cfg=cfg, rcfg=rcfg, params=params, batch=batch, want=want)


@functools.lru_cache(maxsize=None)
def _family_jobs():
    """Every family's setup, started at once on a few threads: tracing
    one reference while XLA compiles another halves the file's time."""
    pool = ThreadPoolExecutor(4)
    jobs = {arch: pool.submit(_family_setup, arch) for arch in ARCHS}
    pool.shutdown(wait=False)
    return jobs


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    return _family_jobs()[request.param].result()


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_logits_match_reference(family):
    got, aux = model.forward(family["cfg"], family["params"],
                             _tbatch(family["batch"]))
    want = np.asarray(family["want"][0])
    assert got.shape == want.shape
    close_to_scale(got.detach().numpy(), want, LOGIT_TOL, "logits")
    assert set(aux) == {"load_balance", "router_z"}


def test_loss_and_metrics_match_reference(family):
    """`loss_fn`'s total and metrics; the reference's total is its task
    loss plus its aux terms by the reference's AUX_WEIGHTS."""
    total, met = model.loss_fn(family["cfg"], family["params"],
                               _tbatch(family["batch"]))
    rmet = family["want"][1]
    rtotal = float(rmet["loss"]) + sum(
        w * float(rmet[k]) for k, w in ref_model.AUX_WEIGHTS.items()
        if k in rmet)
    np.testing.assert_allclose(float(total), rtotal, rtol=LOSS_TOL)
    assert set(met) == set(rmet)
    for k, v in rmet.items():
        np.testing.assert_allclose(float(met[k]), float(v), rtol=LOSS_TOL,
                                   atol=1e-7, err_msg=k)


def test_phase_steps_match_reference(family):
    """One phase-e step (header frozen) and one phase-h step (extractor
    frozen) from the same state: the new parameters and momenta within
    1e-4 of each leaf's scale. For the MoE configs the gradient is the
    total's (the aux terms included), as the reference's."""
    cfg = family["cfg"]
    opt = sgd(LR, momentum=MOM, weight_decay=WD)
    steps = make_phase_steps(cfg, opt)
    e, h = split_params(cfg, family["params"])
    batch = _tbatch(family["batch"])
    e2, oe, _ = steps.phase_e(e, h, opt.init(e), batch)
    h2, oh, _ = steps.phase_h(e, h, opt.init(h), batch)
    want = family["want"][2:]
    for got, ref, what in ((e2, want[0], "extractor"),
                           (oe["mu"], want[1], "opt_e"),
                           (h2, want[2], "header"),
                           (oh["mu"], want[3], "opt_h")):
        g = _leaves(convert.params_to_reference(got, family=cfg.family))
        w = _leaves(ref)
        assert len(g) == len(w), what
        for a, b in zip(g, w):
            close_to_scale(a, np.asarray(b), STEP_TOL, what)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"])
def test_moe_phase_e_differentiates_the_total_with_aux(arch, monkeypatch):
    """The repaired fault: a MoE phase-e step follows the gradient of
    `loss_fn`'s total, the aux terms included, and so equals the
    reference's; the task loss's gradient alone (the old step) lands
    outside the step comparison's tolerance."""
    job = _family_jobs()[arch].result()
    cfg = job["cfg"]
    opt = sgd(LR, momentum=MOM, weight_decay=WD)
    steps = make_phase_steps(cfg, opt)
    e, h = split_params(cfg, job["params"])
    batch = _tbatch(job["batch"])
    want = _leaves(job["want"][2])
    got = _leaves(convert.params_to_reference(
        steps.phase_e(e, h, opt.init(e), batch)[0], family=cfg.family))
    for a, b in zip(got, want):
        close_to_scale(a, np.asarray(b), STEP_TOL, "with aux")
    monkeypatch.setattr(model, "AUX_WEIGHTS", {})
    old = _leaves(convert.params_to_reference(
        steps.phase_e(e, h, opt.init(e), batch)[0], family=cfg.family))
    worst = max(float(np.abs(a - np.asarray(b)).max())
                / max(1.0, float(np.abs(np.asarray(b)).max()))
                for a, b in zip(old, want))
    assert worst > STEP_TOL, worst        # 2.2e-4 and 5.0e-4 of the scale


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "rwkv6-7b",
                                  "recurrentgemma-2b", "whisper-base"])
def test_remat_equals_no_remat(arch):
    """Recomputing each layer in the backward changes no result: the
    loss and every gradient equal within f32 rounding."""
    _, cfg = _cfgs(arch)
    params = model.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = _tbatch(_batch(cfg, seed=1))
    outs = []
    for remat in (False, True):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        total, _ = model.loss_fn(cfg, p, batch, remat=remat)
        grads = torch.autograd.grad(total, tree_leaves(p),
                                    allow_unused=True,
                                    materialize_grads=True)
        outs.append((total.detach(), grads))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-6, atol=0)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_rwkv_chunked_forward_matches_reference():
    """rwkv's "chunked" route (`wkv_chunked_torch`) against the
    reference's forward by `wkv_chunked_jax`, and its prefill, which
    used to raise."""
    rcfg, cfg = _cfgs("rwkv6-7b")
    params = model.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    rparams = convert.params_to_reference(params, family=cfg.family)
    batch = _batch(cfg, seed=2)
    want = run_jit(lambda p, b: ref_model.forward(rcfg, p, b,
                                                  backend="chunked")[0],
                   rparams, batch)
    got, _ = model.forward(cfg, params, _tbatch(batch), backend="chunked")
    close_to_scale(got.detach().numpy(), np.asarray(want), LOGIT_TOL,
                   "chunked logits")
    pre, _ = rwkv.rwkv_prefill(params, _tbatch(batch)["tokens"], cfg,
                               backend="chunked")
    close_to_scale(pre.numpy(), np.asarray(want), LOGIT_TOL, "prefill")


@pytest.mark.parametrize("s,chunk,sub", [(40, 16, 4), (37, 512, 16),
                                         (64, 32, 8)])
def test_wkv_chunked_torch_matches_reference(s, chunk, sub):
    """The closed-form chunked WKV against the reference's, with a
    ragged tail (padded with w = 1) and an initial state."""
    rng = np.random.default_rng(s)
    b, h, hd = 2, 3, 8
    r, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.05, 0.999, size=(b, s, h, hd)).astype(np.float32)
    u = rng.normal(size=(h, hd)).astype(np.float32)
    st = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    want_o, want_s = run_jit(lambda *a: ref_rwkv.wkv_chunked_jax(
        *a, chunk=chunk, sub_chunk=sub), r, k, v, w, u, st)
    got_o, got_s = rwkv.wkv_chunked_torch(
        *(torch.from_numpy(a) for a in (r, k, v, w, u, st)), chunk=chunk,
        sub_chunk=sub)
    close_to_scale(got_o.numpy(), np.asarray(want_o), 1e-5, "out")
    close_to_scale(got_s.numpy(), np.asarray(want_s), 1e-5, "state")


def test_wkv_chunked_torch_gradient_is_finite_where_decays_underflow():
    """At full width a decay w = exp(−exp(logw)) can underflow to 0: the
    chunked route clamps it to 1e-38, as the reference does, and its
    gradient stays finite (the clamp by a select, the off-diagonal
    exponents masked before the exp); r, k and v's gradients agree with
    the per-token recurrence's."""
    from repro_torch.kernels.ref import wkv_ref

    g = torch.Generator().manual_seed(5)
    r, k, v = (torch.randn((1, 64, 2, 8), generator=g).requires_grad_(True)
               for _ in range(3))
    w = torch.rand((1, 64, 2, 8), generator=g)
    w[0, 3, 0, 0], w[0, 10, 1, 2] = 0.0, 1e-40
    w.requires_grad_(True)
    u = torch.randn((2, 8), generator=g)
    grads = []
    for fn in (rwkv.wkv_chunked_torch, wkv_ref):
        out, st = fn(r, k, v, w, u)
        grads.append(torch.autograd.grad(out.sum() + st.sum(),
                                         (r, k, v, w)))
    assert all(bool(torch.isfinite(x).all()) for x in grads[0])
    for a, b in zip(grads[0][:3], grads[1][:3]):
        close_to_scale(a.numpy(), b.numpy(), 1e-5, "wkv gradient")


def _opt_trace(opt, apply, params, grads, steps):
    """`steps` updates of `opt` with fixed gradients, each applied by
    `apply` (the package's `apply_updates`) → the params after each step
    and the final state."""
    state = opt.init(params)
    out = []
    for g in grads[:steps]:
        upd, state = opt.update(g, state, params)
        params = apply(params, upd)
        out.append(params)
    return out, state


@pytest.mark.parametrize("name", ["constant", "cosine_decay",
                                  "warmup_cosine", "adamw_float"])
def test_adamw_and_schedules_match_reference(name):
    """AdamW (f32 moments, bias correction, decoupled decay) under each
    schedule, five steps on a small tree: parameters and moments within
    1e-6."""
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)
    lr, rlr = {
        "constant": (schedules.constant(3e-3), ref_schedules.constant(3e-3)),
        "cosine_decay": (schedules.cosine_decay(3e-3, 4),
                         ref_schedules.cosine_decay(3e-3, 4)),
        "warmup_cosine": (schedules.warmup_cosine(3e-3, 2, 5),
                          ref_schedules.warmup_cosine(3e-3, 2, 5)),
        "adamw_float": (3e-3, 3e-3)}[name]
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        for _ in range(5)]
    want, wstate = _opt_trace(ref_adam.adamw(rlr, **kw), ref_apply,
                              jax.tree_util.tree_map(jnp.asarray, params),
                              grads, 5)
    tparams = jax.tree_util.tree_map(torch.from_numpy, params)
    tgrads = [jax.tree_util.tree_map(torch.from_numpy, g) for g in grads]
    got, gstate = _opt_trace(adamw(lr, **kw), apply_updates, tparams,
                             tgrads, 5)
    for g, w in zip(got, want):
        for a, b in zip(_leaves(g), _leaves(w)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    for key in ("m", "v"):
        for a, b in zip(_leaves(gstate[key]), _leaves(wstate[key])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    assert int(gstate["count"]) == int(wstate["count"]) == 5


@pytest.mark.parametrize("name,fn,args", [
    ("constant", "constant", (0.1,)),
    ("cosine_decay", "cosine_decay", (0.1, 7, 0.2)),
    ("warmup_cosine", "warmup_cosine", (0.1, 3, 9, 0.05))])
def test_schedules_match_reference(name, fn, args):
    """Each schedule's rate at steps 0..11 within 1e-6 of the
    reference's."""
    steps = np.arange(12, dtype=np.int32)
    want = [float(getattr(ref_schedules, fn)(*args)(jnp.asarray(s)))
            for s in steps]
    got = [float(getattr(schedules, fn)(*args)(
        torch.tensor(int(s), dtype=torch.int32))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def test_sgd_schedule_and_nesterov_match_reference():
    """SGD takes a schedule through `resolve_lr` and nesterov, as the
    reference's."""
    rng = np.random.default_rng(4)
    params = {"w": rng.normal(size=(6,)).astype(np.float32)}
    grads = [{"w": rng.normal(size=(6,)).astype(np.float32)}
             for _ in range(4)]
    rl, tl = (ref_schedules.warmup_cosine(0.1, 1, 4),
              schedules.warmup_cosine(0.1, 1, 4))
    want, _ = _opt_trace(ref_sgd(rl, momentum=0.9, weight_decay=0.01,
                                 nesterov=True), ref_apply,
                         {"w": jnp.asarray(params["w"])}, grads, 4)
    got, _ = _opt_trace(sgd(tl, momentum=0.9, weight_decay=0.01,
                            nesterov=True), apply_updates,
                        {"w": torch.from_numpy(params["w"])},
                        [{"w": torch.from_numpy(g["w"])} for g in grads], 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["w"].numpy(), np.asarray(w["w"]),
                                   rtol=1e-6, atol=1e-7)
