"""How the reference rounds the operands of its products: fp32 as they are, or fp8."""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite e4m3 value


class Numerics:
    """fp32 products: every operand as it is."""

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        return F.conv2d(self.q(x), self.q(w), b, stride, padding, 1, groups)

    def conv_transpose(self, x, w, b, stride):
        return F.conv_transpose2d(self.q(x), self.q(w), b, stride)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


class Fp8Numerics(Numerics):
    """An fp8 inference of the same model: both operands of every product, and
    its result, rounded to fp8 e4m3 with one scale per tensor (its absolute
    maximum over 448); the products summed in fp32.  The result is stored in
    fp8 as the program stores its activations in bf16."""

    def q(self, x: torch.Tensor) -> torch.Tensor:
        scale = x.detach().abs().amax().float().clamp_min(1e-12) / FP8_MAX
        return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        return self.q(super().conv(x, w, b, stride, padding, groups))

    def conv_transpose(self, x, w, b, stride):
        return self.q(super().conv_transpose(x, w, b, stride))

    def matmul(self, a, b):
        return self.q(super().matmul(a, b))


FP32 = Numerics()
