"""Batched serving — prefill + greedy decode for every LLM family: dense,
moe, vlm, ssm, hybrid and audio (reference `repro.launch.serve`).

`generate` prefills a batch of prompts and decodes one token at a time
with the family's cache (the KV cache of the dense, moe and vlm
families, deepseek's MLA latent cache, the WKV state of rwkv6, the LRU
states and window rings of recurrentgemma, whisper's decoder self-cache
and cross k/v). The vlm family serves text tokens only, as the
reference's driver does. The audio family's frames are the reference
driver's stub: zeros of shape (B, encoder_seq, d_model) in the model
dtype. `make_serving_fns` splits the two phases so `serve_requests`
can time each per request with a first/steady split (`StageTimes`):
request 0 pays the kernels' build and the libraries' warm-up, later
requests measure the steady state.

The prefill goes through backend="flash": on a card the hand-written
flash_attention / wkv_chunked kernels, on the CPU their plain versions.
(The reference's `launch/serve.py` prefills with backend="naive"; both routes
compute one function, see PERF.md.) The decode is a Python loop over
positions; greedy by default, masking the padded vocabulary to −1e30.
`--ckpt-dir` restores the parameters from the latest checkpoint there
(`repro_torch.checkpoint`, the reference's format, so either package's
file), as the reference's driver does.

CPU-scale example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --device cpu --batch 4 --prompt-len 32 --gen 16 \\
      --requests 4
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import latest_checkpoint, load_checkpoint
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as model_mod
from repro_torch.models.layers import torch_dtype
from repro_torch.obs.timers import StageTimes

PREFILL_BACKEND = "flash"


def serving_batch(cfg, prompts) -> dict:
    """The prefill's batch for prompts (B, S): the tokens (alone for the
    vlm family too: no image prefix), and for the audio family zero frames
    (B, encoder_seq, d_model) in cfg.dtype on the prompts' device, as the
    reference's driver feeds them."""
    batch = {"tokens": prompts}
    if cfg.family == "audio":
        batch["frames"] = torch.zeros(
            (prompts.shape[0], cfg.encoder_seq, cfg.d_model),
            dtype=torch_dtype(cfg.dtype), device=prompts.device)
    return batch


def _next_token(cfg, logits, greedy: bool, generator):
    """logits (B, V) f32 → (B,) int32: argmax (first maximum) or a draw
    from the softmax; the padded vocabulary never wins."""
    valid = torch.arange(logits.shape[-1], device=logits.device) \
        < cfg.vocab_size
    logits = torch.where(valid, logits, -1e30)
    if greedy:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _decode(cfg, params, cache, logits, start: int, gen_tokens: int,
            greedy: bool, generator):
    """The decode loop: pick a token from `logits` (B, 1, V), run one
    decode step at position start + i, repeat. → ((B, gen) int32 tokens,
    0-dim bool: every step's logits were finite)."""
    toks = []
    finite = torch.isfinite(logits).all()
    for i in range(gen_tokens):
        nxt = _next_token(cfg, logits[:, -1], greedy, generator)
        logits, cache = model_mod.decode_step(cfg, params, cache,
                                              nxt[:, None], start + i)
        logits = logits.float()
        finite = finite & torch.isfinite(logits).all()
        toks.append(nxt)
    if not toks:
        return logits.new_zeros((logits.shape[0], 0), dtype=torch.int32), \
            finite
    return torch.stack(toks, dim=1), finite


def generate(cfg, params, prompts, *, gen_tokens: int, greedy=True,
             generator=None):
    """prompts (B, S) int → (B, S + gen) tokens, on the prompts' device."""
    b, s = prompts.shape
    logits, cache = model_mod.prefill(cfg, params,
                                      serving_batch(cfg, prompts),
                                      max_seq=s + gen_tokens,
                                      backend=PREFILL_BACKEND)
    if generator is None:
        generator = torch.Generator(device=prompts.device).manual_seed(0)
    toks, _ = _decode(cfg, params, cache, logits[:, -1:].float(), s,
                      gen_tokens, greedy, generator)
    return torch.cat([prompts, toks.to(prompts.dtype)], dim=1)


def make_serving_fns(cfg, *, prompt_len: int, gen_tokens: int, greedy=True):
    """→ (prefill_fn, decode_fn):

    prefill_fn(params, prompts) → (last-position logits (B, 1, V) f32,
        decode cache)
    decode_fn(params, cache, logits, generator) → ((B, gen) int32 tokens,
        0-dim bool: every decode step's logits were finite)
    """
    max_seq = prompt_len + gen_tokens

    def prefill_fn(params, prompts):
        logits, cache = model_mod.prefill(cfg, params,
                                          serving_batch(cfg, prompts),
                                          max_seq=max_seq,
                                          backend=PREFILL_BACKEND)
        return logits[:, -1:].float(), cache

    def decode_fn(params, cache, logits, generator):
        return _decode(cfg, params, cache, logits, prompt_len, gen_tokens,
                       greedy, generator)

    return prefill_fn, decode_fn


def serve_requests(cfg, params, prompts_fn, *, num_requests: int,
                   prompt_len: int, gen_tokens: int, greedy=True, seed=0):
    """Serve `num_requests` batches through the split prefill/decode,
    timing each phase per request on the host clock; on a card each
    timed phase ends in `torch.cuda.synchronize()`.

    prompts_fn(i) → (B, prompt_len) int prompts for request i, on the
    device to serve on. → (last request's (B, prompt+gen) tokens, stats):
      stages         {prefill|decode: {first_s, steady_s, compile_s, calls}}
      requests       per-request latency list (request 0 = warm-up)
      logits_finite  per request: the prefill's last-position logits and
                     every decode step's logits were finite
    """
    prefill_fn, decode_fn = make_serving_fns(
        cfg, prompt_len=prompt_len, gen_tokens=gen_tokens, greedy=greedy)
    times = StageTimes()
    request_s, finite, out = [], [], None
    for i in range(num_requests):
        prompts = prompts_fn(i)
        dev = prompts.device

        def fence():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        generator = torch.Generator(device=dev).manual_seed(
            seed * 1_000_003 + i)
        t0 = time.perf_counter()
        with times.timed("prefill"):
            logits, cache = prefill_fn(params, prompts)
            fence()
        with times.timed("decode"):
            toks, dec_finite = decode_fn(params, cache, logits, generator)
            fence()
        request_s.append(time.perf_counter() - t0)
        finite.append(bool(torch.isfinite(logits).all() & dec_finite))
        out = torch.cat([prompts, toks.to(prompts.dtype)], dim=1)
    stats = {
        "stages": times.summary(),
        "requests": [round(t, 6) for t in request_s],
        "logits_finite": finite,
    }
    return out, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the parameters from the latest "
                         "checkpoint in this directory (either package's "
                         "format), if there is one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=1,
                    help="number of requests to serve; request 0 pays "
                         "the kernels' build and warm-up, later requests "
                         "measure steady-state latency")
    ap.add_argument("--latency-out", default=None,
                    help="write the per-request latency counters "
                         "(prefill/decode first/steady/compile) as JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "cnn":
        raise SystemExit("cnn has no decode step")
    params = model_mod.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    if args.ckpt_dir:
        path = latest_checkpoint(args.ckpt_dir)
        if path:
            params, _ = load_checkpoint(path, like=params, device=dev)
            print(f"restored {path}")

    def prompts_fn(i):
        g = torch.Generator(device=dev).manual_seed(args.seed + 1 + i)
        return torch.randint(0, cfg.vocab_size,
                             (args.batch, args.prompt_len), generator=g,
                             device=dev, dtype=torch.int32)

    t0 = time.time()
    out, stats = serve_requests(
        cfg, params, prompts_fn, num_requests=args.requests,
        prompt_len=args.prompt_len, gen_tokens=args.gen, seed=args.seed)
    dt = time.time() - t0
    n_new = args.batch * args.gen
    print(f"arch={cfg.name} device={dev} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} "
          f"requests={args.requests}")
    print(f"generated {n_new * args.requests} tokens in {dt:.2f}s "
          f"({n_new * args.requests / dt:.1f} tok/s incl. warm-up)")
    for name, s in stats["stages"].items():
        print(f"  {name:8s} first={s['first_s']:.3f}s "
              f"steady={s['steady_s']:.3f}s compile={s['compile_s']:.3f}s "
              f"calls={s['calls']}")
    steady_reqs = stats["requests"][1:]
    if steady_reqs:
        steady = sum(steady_reqs) / len(steady_reqs)
        print(f"  steady request latency {steady:.3f}s "
              f"({n_new / steady:.1f} tok/s)")
    if args.latency_out:
        with open(args.latency_out, "w") as fh:
            json.dump({"arch": cfg.name, "device": str(dev),
                       "batch": args.batch, "prompt_len": args.prompt_len,
                       "gen": args.gen, **stats}, fh, indent=1)
        print("wrote", args.latency_out)
    print("sample:", out[0, -args.gen:].tolist())
    return out


if __name__ == "__main__":
    main()
