"""The cells' traffic, drawn from the seed: each client's training rows
and, round by round, the draws the round function takes (participants,
batch rows, probe rows).

The data follow the port's synthetic generators in distribution (a copy
of their arithmetic, `repro_torch.data.synthetic`): heterogeneous token
streams (each client a vocabulary domain with probability 0.7, else a
Zipf-like background) and the CIFAR stand-in (smooth class prototypes
plus noise) under the pathological partition. Everything is drawn on
the CPU from torch and numpy generators, so a seed gives the same rows on
any device.

Batch rows: where a round's steps fit in a client's rows they are drawn
without replacement (every row of a round differs); otherwise with
replacement. The sizes never depend on the seed.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def stream_seed(*words) -> int:
    ws = []
    for w in words:
        ws += [int(w) & 0xFFFFFFFF, int(w) >> 32]
    return int(np.random.SeedSequence(ws).generate_state(1, np.uint64)[0]
               >> 1)


# ---- client data ------------------------------------------------------------

def token_rows(seed: int, data: dict, model: dict) -> dict:
    """{"tokens": (M, n, S) int32}: seqs_per_client sequences a client,
    the first `held_out` of them dropped (the test split)."""
    m, vocab = data["num_clients"], model["vocab_size"]
    shape = (data["seqs_per_client"], data["seq_len"])
    domains = data["num_domains"]
    dom_size = vocab // domains
    gen = torch.Generator().manual_seed(stream_seed(seed, 0xDA7A))
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32)
    background = torch.softmax(-1.1 * torch.log(ranks), dim=0)
    out = []
    for c in range(m):
        in_dom = torch.rand(shape, generator=gen) < data["domain_frac"]
        dom_tok = (c % domains) * dom_size + torch.randint(
            0, dom_size, shape, generator=gen)
        bg_tok = torch.multinomial(background, in_dom.numel(),
                                   replacement=True,
                                   generator=gen).reshape(shape)
        out.append(torch.where(in_dom, dom_tok, bg_tok))
    tokens = torch.stack(out).to(torch.int32)
    return {"tokens": tokens[:, data["held_out"]:].contiguous()}


def _prototypes(gen, classes: int, size: int, channels: int, bands=4):
    coeff = torch.randn((classes, bands, bands, channels), generator=gen)
    xs = torch.linspace(0, math.pi, size)
    basis = torch.stack([torch.cos(b * xs) for b in range(bands)])
    proto = torch.einsum("kabc,ah,bw->khwc", coeff, basis, basis)
    rms = proto.square().mean(dim=(1, 2, 3), keepdim=True).sqrt()
    return proto / (rms + 1e-6)


def image_rows(seed: int, data: dict, model: dict) -> dict:
    """{"images": (M, n, H, W, C) f32, "labels": (M, n) int32}: the
    training split of each client's class shards."""
    classes, size = model["num_classes"], model["image_size"]
    channels, spc = model["image_channels"], data["samples_per_class"]
    gen = torch.Generator().manual_seed(stream_seed(seed, 0xC1FA))
    protos = _prototypes(gen, classes, size, channels)
    n = classes * spc
    labels = torch.arange(classes).repeat_interleave(spc)
    noise = torch.randn((n, size, size, channels), generator=gen)
    images = protos[labels] + data["noise_scale"] * noise
    perm = torch.randperm(n, generator=gen)
    images, labels = images[perm], labels[perm].numpy()
    # the pathological partition: whole single-class shards, dealt out
    m, per = data["num_clients"], data["classes_per_client"]
    rng = np.random.default_rng(stream_seed(seed, 0x5A4D))
    shards_n = m * per
    base, extra = divmod(shards_n, classes)
    per_class = [base + (c < extra) for c in range(classes)]
    size_s = min(int(np.sum(labels == c)) // s
                 for c, s in enumerate(per_class) if s)
    shards = []
    for c in range(classes):
        idx = rng.permutation(np.where(labels == c)[0])
        shards += [idx[s * size_s:(s + 1) * size_s]
                   for s in range(per_class[c])]
    dealt = np.stack(shards)[rng.permutation(shards_n)]
    dealt = dealt.reshape(m, per, size_s)
    n_test = max(1, int(size_s * data["test_frac"]))
    train = torch.as_tensor(dealt[:, :, n_test:].reshape(m, -1))
    return {"images": images[train].float(),
            "labels": torch.as_tensor(labels)[train].to(torch.int32)}


ROWS = {"tokens": token_rows, "images": image_rows}


def client_rows(seed: int, cell: dict, model: dict) -> dict:
    return ROWS[cell["data"]["kind"]](seed, cell["data"], model)


# ---- per-round draws -------------------------------------------------------

def _rows(gen, n_rows: int, count: int):
    """`count` row ids of one client: distinct where they fit."""
    if count <= n_rows:
        return torch.randperm(n_rows, generator=gen)[:count]
    return torch.randint(0, n_rows, (count,), generator=gen)


def round_draws(cell: dict, seed: int, r: int, n_rows: int) -> dict:
    """Round r's draws, as the PFedDST round function's `draws=` takes
    them: "act" (n,) participants, "probe" (M, probe), "e" (K_e·spe, n,
    B), "h" (K_h·spe, n, B). CPU tensors."""
    fl, spe = cell["fl"], cell["steps_per_epoch"]
    m, b = fl["num_clients"], fl["batch_size"]
    n = max(1, int(round(m * fl["client_sample_ratio"])))
    gen = torch.Generator().manual_seed(stream_seed(seed, r, 0xD4A3))
    act = torch.randperm(m, generator=gen)[:n]
    n_e = fl["epochs_extractor"] * spe
    n_h = fl["epochs_header"] * spe
    rows = torch.stack([_rows(gen, n_rows, (n_e + n_h) * b)
                        for _ in range(n)])                   # (n, steps·B)
    rows = rows.view(n, n_e + n_h, b).transpose(0, 1)
    probe = torch.stack([_rows(gen, n_rows, fl["probe_size"])
                         for _ in range(m)])
    return {"act": act, "probe": probe, "e": rows[:n_e].contiguous(),
            "h": rows[n_e:].contiguous()}
