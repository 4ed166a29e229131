"""Synthetic CIFAR stand-in, the paper's pathological partition, and
federated token streams for the LLM families — reference
`repro.data.synthetic`.

The draws come from a torch.Generator (images) and numpy's default_rng
(the partition), so the arrays differ from the reference's; they match it
in distribution: class-conditional smooth prototypes plus white noise,
and every client holding `classes_per_client` classes with identical
class subsets in its train and test splits. Parity tests feed both
packages the reference's arrays instead.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def class_prototypes(generator: torch.Generator, num_classes: int,
                     image_size: int, channels: int, bands: int = 4):
    """Smooth low-frequency prototype per class, unit RMS."""
    coeff = torch.randn((num_classes, bands, bands, channels),
                        generator=generator)
    xs = torch.linspace(0, math.pi, image_size)
    basis = torch.stack([torch.cos(b * xs) for b in range(bands)])
    proto = torch.einsum("kabc,ah,bw->khwc", coeff, basis, basis)
    rms = proto.square().mean(dim=(1, 2, 3), keepdim=True).sqrt()
    return proto / (rms + 1e-6)


def synth_cifar(seed: int, num_classes: int = 10,
                samples_per_class: int = 500, image_size: int = 32,
                channels: int = 3, noise_scale: float = 0.8):
    """→ (images (N, H, W, C) f32, labels (N,) int32), class-balanced,
    shuffled."""
    gen = torch.Generator().manual_seed(seed)
    protos = class_prototypes(gen, num_classes, image_size, channels)
    n = num_classes * samples_per_class
    labels = torch.arange(num_classes).repeat_interleave(samples_per_class)
    noise = torch.randn((n, image_size, image_size, channels), generator=gen)
    images = protos[labels] + noise_scale * noise
    perm = torch.randperm(n, generator=gen)
    return images[perm].float(), labels[perm].to(torch.int32)


def pathological_partition(seed: int, labels, num_clients: int,
                           classes_per_client: int, num_classes: int):
    """Class-aligned shards: each class's pool is cut into whole
    single-class shards and every client is dealt `classes_per_client`
    of them, so a client holds at most that many classes.

    → (M, n_local) int64 index matrix into the dataset."""
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    n_shards = num_clients * classes_per_client
    base, extra = divmod(n_shards, num_classes)
    shards_per_class = [base + (1 if c < extra else 0)
                        for c in range(num_classes)]
    usable = [int(np.sum(labels == c)) for c in range(num_classes)]
    shard_size = min(u // s for u, s in zip(usable, shards_per_class)
                     if s > 0)
    shards = []
    for c in range(num_classes):
        if shards_per_class[c] == 0:
            continue
        idx = rng.permutation(np.where(labels == c)[0])
        for s in range(shards_per_class[c]):
            shards.append(idx[s * shard_size:(s + 1) * shard_size])
    shards = np.stack(shards)
    per_client = shards[rng.permutation(n_shards)].reshape(
        num_clients, classes_per_client * shard_size)
    return torch.as_tensor(per_client, dtype=torch.int64)


def client_datasets_cifar(seed: int, num_clients: int,
                          num_classes: int = 10, classes_per_client: int = 2,
                          samples_per_class: int = 500, image_size: int = 32,
                          noise_scale: float = 0.8, test_frac: float = 0.2):
    """Per-client train/test splits over the same class subset (§III-A).

    → dict of CPU tensors: train_x (M, n_tr, H, W, C), train_y (M, n_tr),
    test_x (M, n_te, H, W, C), test_y (M, n_te)."""
    images, labels = synth_cifar(seed, num_classes, samples_per_class,
                                 image_size, noise_scale=noise_scale)
    idx = pathological_partition(seed + 1, labels, num_clients,
                                 classes_per_client, num_classes)
    m, n_local = idx.shape
    shard_size = n_local // classes_per_client
    idx_s = idx.reshape(m, classes_per_client, shard_size)
    n_te_s = max(1, int(shard_size * test_frac))
    te = idx_s[:, :, :n_te_s].reshape(m, -1)
    tr = idx_s[:, :, n_te_s:].reshape(m, -1)
    return {"train_x": images[tr], "train_y": labels[tr],
            "test_x": images[te], "test_y": labels[te]}


def synth_tokens(seed: int, num_clients: int, vocab_size: int, seq_len: int,
                 seqs_per_client: int, num_domains: int = 0,
                 domain_frac: float = 0.7):
    """Heterogeneous token streams (reference `synth_tokens`). Client c
    belongs to domain c % D (D = num_domains, or max(2, M // 4)); a domain
    is a contiguous vocab slice. Each token is drawn from the client's
    domain slice with probability domain_frac, else from a Zipf-like
    background (logits −1.1·log rank) over the whole vocab.

    The draws come from a torch.Generator seeded by `seed` (client by
    client: the domain coin, the domain token, the background token), so
    the tokens follow the reference's distribution, not its bits; parity
    tests feed both packages the reference's tokens.

    → tokens (M, n, S) int32 and domains (M,) int32, CPU tensors."""
    num_domains = num_domains or max(2, num_clients // 4)
    dom_size = vocab_size // num_domains
    gen = torch.Generator().manual_seed(seed)
    domains = torch.arange(num_clients) % num_domains
    ranks = torch.arange(1, vocab_size + 1, dtype=torch.float32)
    bg_probs = torch.softmax(-1.1 * torch.log(ranks), dim=0)
    shape = (seqs_per_client, seq_len)
    tokens = []
    for c in range(num_clients):
        in_dom = torch.rand(shape, generator=gen) < domain_frac
        dom_tok = int(domains[c]) * dom_size + torch.randint(
            0, dom_size, shape, generator=gen)
        bg_tok = torch.multinomial(bg_probs, in_dom.numel(), replacement=True,
                                   generator=gen).reshape(shape)
        tokens.append(torch.where(in_dom, dom_tok, bg_tok))
    return torch.stack(tokens).to(torch.int32), domains.to(torch.int32)
