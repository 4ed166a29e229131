"""Plain reference of the paper's ResNet-18 for 32x32 CIFAR images (He et
al. 2016, arXiv:1512.03385; PFedDST arXiv:2502.07750 §III) with
GroupNorm in place of BatchNorm.

The model as the configuration defines it: a 3x3 stem, four stages of
two basic blocks (widths w, 2w, 4w, 8w; the first block of stages 2-4
strided by 2 with a 1x1 projection), "SAME" padding as XLA pads it (a
strided 3x3 conv on an even map pads 0 before and 1 after), GroupNorm
whose mean and variance run over the C/G channels of a group at each
position, global average pooling and a linear head. Parameter names are
the benchmark's flat dotted names; convolutions are OIHW. Images come
in NHWC, float32 throughout.
"""
from __future__ import annotations

import math

import torch

HEADER = ("head",)


def widths(cfg: dict) -> list:
    return [cfg["cnn_width"] * 2 ** i for i in range(len(cfg["cnn_stages"]))]


def param_specs(cfg: dict) -> dict:
    """{name: (shape, init)}: He-normal convs, unit/zero GroupNorm, a
    0.01-std head."""
    specs = {}

    def conv(name, k, cin, cout):
        specs[name] = ((cout, cin, k, k),
                       ("normal", math.sqrt(2.0 / (k * k * cin))))

    def gn(name, c):
        specs[name + ".scale"] = ((c,), ("const", 1.0))
        specs[name + ".bias"] = ((c,), ("const", 0.0))

    ws = widths(cfg)
    conv("stem.conv", 3, cfg["image_channels"], ws[0])
    gn("stem.gn", ws[0])
    cin = ws[0]
    for si, (blocks, cout) in enumerate(zip(cfg["cnn_stages"], ws)):
        for bi in range(blocks):
            p = f"stages.{si}.{bi}"
            conv(p + ".conv1", 3, cin, cout)
            gn(p + ".gn1", cout)
            conv(p + ".conv2", 3, cout, cout)
            gn(p + ".gn2", cout)
            if cin != cout:
                conv(p + ".proj", 1, cin, cout)
            cin = cout
    specs["head.w"] = ((cin, cfg["num_classes"]), ("normal", 0.01))
    specs["head.b"] = ((cfg["num_classes"],), ("const", 0.0))
    return specs


def _conv(x, w, stride, num):
    pads = []
    for size, k in ((x.shape[2], w.shape[2]), (x.shape[3], w.shape[3])):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads.append((total // 2, total - total // 2))
    (t, b), (l, r) = pads
    if t != b or l != r:
        x = torch.nn.functional.pad(x, (l, r, t, b))
        t = l = 0
    return num.conv(x, w.float(), stride, (t, l))


def _gn(x, p, name, groups):
    n, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(n, h, w, groups, c // groups)
    mu = y.mean(-1, keepdim=True)
    var = (y - mu).square().mean(-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(n, h, w, c)
    y = y * p[name + ".scale"].float() + p[name + ".bias"].float()
    return y.permute(0, 3, 1, 2)


def class_logits(p: dict, images, cfg: dict, num):
    """images (B, H, W, C) -> (B, classes) float32."""
    g = cfg["gn_groups"]
    relu = torch.nn.functional.relu
    x = images.float().permute(0, 3, 1, 2)
    x = relu(_gn(_conv(x, p["stem.conv"], 1, num), p, "stem.gn", g))
    for si, blocks in enumerate(cfg["cnn_stages"]):
        for bi in range(blocks):
            pre = f"stages.{si}.{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            h = relu(_gn(_conv(x, p[pre + ".conv1"], stride, num), p,
                         pre + ".gn1", g))
            h = _gn(_conv(h, p[pre + ".conv2"], 1, num), p, pre + ".gn2", g)
            if pre + ".proj" in p:
                x = _conv(x, p[pre + ".proj"], stride, num)
            elif stride != 1:
                x = x[:, :, ::stride, ::stride]
            x = relu(x + h)
    return num.mm(x.mean(dim=(2, 3)), p["head.w"]) + p["head.b"].float()


def row_nll(p: dict, batch: dict, cfg: dict, num):
    z = class_logits(p, batch["images"], cfg, num)
    return torch.logsumexp(z, -1) - z.gather(
        -1, batch["labels"].long().unsqueeze(-1)).squeeze(-1)


def loss(p: dict, batch: dict, cfg: dict, num):
    return row_nll(p, batch, cfg, num).mean()


def batch_rows(batch: dict) -> int:
    return batch["images"].shape[0]
