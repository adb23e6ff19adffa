"""How the reference multiplies: exactly in float32, or as the control does.

Every convolution of the reference goes through one of these objects.
:data:`EXACT` is float32 with TF32 off. ``PRECISIONS["fp8_e4m3"]`` is the
control of the benchmark's comparison: the precision one step below the
configurations' bf16, float8 e4m3 with one scale a tensor (its largest
magnitude mapped to 448, as fp8 training scales operands), applied to both
operands and the output of every convolution in the forward pass and to
the output gradient that reaches it in the backward pass (as the program
keeps its operands, activations and their gradients in bf16); products and
sums stay float32. ``PRECISIONS["bf16"]`` rounds the same tensors to bf16:
a witness of what the configurations' own precision does to the numbers
compared, never a limit's reading.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


class Exact:
    name = "float32"

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(x, w, b, stride=stride, padding=padding)

    def conv_transpose2d(self, x, w, b=None, stride=2, padding=1, output_padding=1):
        return F.conv_transpose2d(x, w, b, stride=stride, padding=padding,
                                  output_padding=output_padding)


EXACT = Exact()


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor,
    back in ``t``'s type."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return ((t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale).to(t.dtype)


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient rounded by ``fn`` on its way back."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _straight(t: torch.Tensor, fn) -> torch.Tensor:
    """``fn(t)`` forward, the gradient passed straight through."""
    return t + (fn(t) - t).detach()


class Rounded:
    """Convolutions whose operands (forward) and output gradient (backward)
    are rounded by ``fn``; with ``round_out`` the output too."""

    def __init__(self, name: str, fn, round_out: bool = False):
        self.name, self.fn, self.round_out = name, fn, round_out

    def _out(self, y):
        if self.round_out:
            y = _straight(y, self.fn)
        return _RoundGrad.apply(y, self.fn) if y.requires_grad else y

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        return self._out(F.conv2d(_straight(x, self.fn), _straight(w, self.fn), b,
                                  stride=stride, padding=padding))

    def conv_transpose2d(self, x, w, b=None, stride=2, padding=1, output_padding=1):
        return self._out(F.conv_transpose2d(_straight(x, self.fn), _straight(w, self.fn), b,
                                            stride=stride, padding=padding,
                                            output_padding=output_padding))


# The control (fp8) and a witness of the configurations' own precision
# (bf16 operands, outputs and output gradients, as the program stores them).
PRECISIONS = {"float32": EXACT, "fp8_e4m3": Rounded("fp8_e4m3", fp8_round, round_out=True),
              "bf16": Rounded("bf16", bf16_round, round_out=True)}
