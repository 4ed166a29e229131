"""ResNet-18 (CIFAR variant) with GroupNorm — reference `repro.models.cnn`.

extractor = stem + stages + global average pool; header = final fc.

Layout: the public functions take NHWC images like the reference.
Internally activations are NCHW views of channels-last memory (the NHWC
input permuted, never copied) and conv weights are OIHW, PyTorch's
layout; `repro_torch.convert` transposes the reference's HWIO weights.

Padding follows XLA's "SAME": a 3×3 stride-2 conv on an even-sized map
pads (0, 1), not (1, 1), so asymmetric pads go through `F.pad`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import group_norm

GN_GROUPS = 8


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, stride: int = 1):
    """NCHW x, OIHW w, XLA "SAME" padding."""
    ph = _same_pads(x.shape[2], w.shape[2], stride)
    pw = _same_pads(x.shape[3], w.shape[3], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def _gn(x, params, prefix):
    return group_norm(x, params[prefix + ".scale"], params[prefix + ".bias"],
                      GN_GROUPS, channel_axis=1)


def stage_widths(cfg):
    return [cfg.cnn_width * (2 ** i) for i in range(len(cfg.cnn_stages))]


def init_cnn(cfg, generator: torch.Generator, device) -> dict:
    """Random init with the reference's scales (He-normal convs, 0.01 fc,
    unit/zero GroupNorm). Draws from `generator`, which must live on
    `device`; the numbers differ from the reference's jax.random init."""
    dtype = getattr(torch, cfg.dtype)

    def conv(kh, kw, cin, cout):
        std = math.sqrt(2.0 / (kh * kw * cin))
        w = torch.randn((cout, cin, kh, kw), generator=generator,
                        device=device) * std
        return w.to(dtype)

    params = {}

    def gn(prefix, c):
        params[prefix + ".scale"] = torch.ones(c, dtype=dtype, device=device)
        params[prefix + ".bias"] = torch.zeros(c, dtype=dtype, device=device)

    widths = stage_widths(cfg)
    params["stem.conv"] = conv(3, 3, cfg.image_channels, widths[0])
    gn("stem.gn", widths[0])
    cin = widths[0]
    for si, (n_blocks, cout) in enumerate(zip(cfg.cnn_stages, widths)):
        for bi in range(n_blocks):
            p = f"stages.{si}.{bi}"
            params[p + ".conv1"] = conv(3, 3, cin, cout)
            gn(p + ".gn1", cout)
            params[p + ".conv2"] = conv(3, 3, cout, cout)
            gn(p + ".gn2", cout)
            if cin != cout:
                params[p + ".proj"] = conv(1, 1, cin, cout)
            cin = cout
    params["head.w"] = (torch.randn((cin, cfg.num_classes),
                                    generator=generator, device=device)
                        * 0.01).to(dtype)
    params["head.b"] = torch.zeros(cfg.num_classes, dtype=dtype,
                                   device=device)
    return params


def basic_block(params, prefix, x, stride: int):
    h = conv2d(x, params[prefix + ".conv1"], stride)
    h = F.relu(_gn(h, params, prefix + ".gn1"))
    h = conv2d(h, params[prefix + ".conv2"], 1)
    h = _gn(h, params, prefix + ".gn2")
    if prefix + ".proj" in params:
        x = conv2d(x, params[prefix + ".proj"], stride)
    elif stride != 1:
        x = x[:, :, ::stride, ::stride]
    return F.relu(x + h)


def cnn_features(params, images, cfg):
    """images: (B, H, W, C) → pooled features (B, D)."""
    w = params["stem.conv"]
    x = images.to(w.dtype).permute(0, 3, 1, 2)
    x = F.relu(_gn(conv2d(x, w, 1), params, "stem.gn"))
    for si, n_blocks in enumerate(cfg.cnn_stages):
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            x = basic_block(params, f"stages.{si}.{bi}", x, stride)
    return x.mean(dim=(2, 3))          # global average pool


def cnn_forward(params, images, cfg):
    feats = cnn_features(params, images, cfg)
    return feats @ params["head.w"] + params["head.b"]
