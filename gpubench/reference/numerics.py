"""Products in the reference's precision, and the SGD step it trains with."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def fp8_round(t):
    """t rounded to float8 e4m3 under one per-tensor scale (its amax to
    448), returned in float32. The gradient passes straight through the
    rounding, so the backward's products take the rounded operands."""
    t = t.float()
    scale = E4M3_MAX / t.detach().abs().amax().clamp_min(1e-30)
    q = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q - t.detach())


class Numerics:
    """The matrix product and convolution of one precision: "float32"
    (the reference) or "fp8" (the control: both operands rounded to e4m3,
    accumulated in float32)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self._q = fp8_round if precision == "fp8" else (lambda t: t.float())

    def mm(self, x, w):
        return self._q(x) @ self._q(w)

    def conv(self, x, w, stride: int, padding):
        return torch.nn.functional.conv2d(self._q(x), self._q(w),
                                          stride=stride, padding=padding)


def sgd_step_(param, grad, mom, *, lr: float, momentum: float,
              weight_decay: float):
    """SGD with momentum and weight decay, the paper's recipe (§III-A) in
    the order the configuration states: the gradient in float32, weight
    decay added before the momentum, a float32 momentum buffer, the
    update -lr·m rounded to the parameter's dtype and added there. Writes
    `param` and `mom` in place."""
    g = grad.float() + weight_decay * param.float()
    mom.mul_(momentum).add_(g)
    update = (-lr * mom).to(param.dtype)
    param.copy_((param.float() + update.float()).to(param.dtype))
