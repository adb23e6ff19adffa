"""The U-Net generator family (``unet_128``: 7 levels, ``unet_256``: 8), the
pix2pix generator (Isola et al., arXiv:1611.07004, section 6.1.1), as the
port's ``UnetGenerator`` builds it.

Levels nest from the outermost (level 0, at the input's size) to the
innermost (at 1 x 1 for an input of 2^levels). Channels, outermost first:
in -> ngf -> 2ngf -> 4ngf -> 8ngf, then 8ngf at every deeper level. A level
on its input ``x``:

- down: LeakyReLU 0.2 (not at the outermost level), a 4x4 stride-2 pad-1
  convolution, instance norm at every level but the innermost and the
  outermost;
- the next level inward, if any;
- up: ReLU, a 4x4 stride-2 pad-1 transposed convolution (output padding
  0), instance norm at every level but the outermost, then dropout 0.5 at
  the ``levels - 5`` middle levels (those just outside the innermost)
  where the generator drops;
- ``cat([x, up], channels)`` at every level but the outermost, which
  returns its up (tanh on the image generator, raw logits on the label
  generator).

Instance norm: biased variance, eps 1e-5, no affine, no activation of its
own. Dropout masks are drawn as the port draws them: a level draws after
the levels inside it, so the innermost middle level draws first, and a
forward's masks in the order of :func:`portbench.reference.nets.dropout_keep`.

Departures from pix2pix: every convolution has a bias (pix2pix has them
under instance norm too, and drops them under batch norm, which no cell
runs); the label generator's head gives raw logits where pix2pix's tanh
stands; the dropout masks follow the port's draw rule, not
``nn.Dropout``'s. The family contract is in
:mod:`portbench.reference.nets`.
"""

from __future__ import annotations

import torch

from portbench.reference.nets import dropout, instance_norm, leaky
from portbench.reference.precision import EXACT

LEVELS = {"unet_128": 7, "unet_256": 8}


def depth(cfg: dict) -> int:
    """The number of levels."""
    if cfg["gen_net"] not in LEVELS:
        raise ValueError(f"{cfg['gen_net']!r} is no U-Net generator ({sorted(LEVELS)})")
    return LEVELS[cfg["gen_net"]]


def prefix(i: int) -> str:
    """The module path of level ``i`` (0: the outermost)."""
    return ".".join(["root"] + ["sub"] * i)


def levels(in_nc: int, out_nc: int, cfg: dict) -> list:
    """[(prefix, down_in, inner, up_out)] outermost first: the module path
    of each level, its down convolution's input channels, its inner
    channels (the down's output) and the up's output channels."""
    ngf = cfg["ngf"]
    chans = [(in_nc, ngf, out_nc), (ngf, 2 * ngf, ngf), (2 * ngf, 4 * ngf, 2 * ngf),
             (4 * ngf, 8 * ngf, 4 * ngf)] + [(8 * ngf, 8 * ngf, 8 * ngf)] * (depth(cfg) - 4)
    return [(prefix(i), *c) for i, c in enumerate(chans)]


def spec(in_nc: int, out_nc: int, cfg: dict) -> list:
    """[(name, shape)] of a U-Net generator's parameters, in the order of
    the module's registration: every level's down, outermost first, then
    every level's up, innermost first."""
    lv = levels(in_nc, out_nc, cfg)
    down, up = [], []
    for i, (pre, cin, inner, cout) in enumerate(lv):
        up_in = inner if i == len(lv) - 1 else 2 * inner
        down += [(f"{pre}.down.weight", (inner, cin, 4, 4)), (f"{pre}.down.bias", (inner,))]
        up += [(f"{pre}.up.weight", (up_in, cout, 4, 4)), (f"{pre}.up.bias", (cout,))]
    return down + [x for i in range(len(lv) - 1, -1, -1) for x in up[2 * i:2 * i + 2]]


def forward(p: dict, x: torch.Tensor, cfg: dict, tanh: bool, q=EXACT,
            drop: torch.Generator | None = None) -> torch.Tensor:
    """The U-Net generator on NCHW ``x``; ``drop``: the dropout masks'
    generator (None: no dropout)."""
    last = depth(cfg) - 1

    def level(i, h_in):
        pre = prefix(i)
        h = h_in if i == 0 else leaky(h_in)
        h = q.conv2d(h, p[f"{pre}.down.weight"], p[f"{pre}.down.bias"], 2, 1)
        if 0 < i < last:
            h = instance_norm(h)
        if i < last:
            h = level(i + 1, h)
        h = q.conv_transpose2d(torch.relu(h), p[f"{pre}.up.weight"], p[f"{pre}.up.bias"],
                               2, 1, 0)
        if i == 0:
            return h
        h = instance_norm(h)
        if drop is not None and 4 <= i < last:
            h = dropout(h, drop)
        return torch.cat([h_in, h], dim=1)

    h = level(0, x)
    return torch.tanh(h) if tanh else h


def macs(in_nc: int, out_nc: int, cfg: dict, h: int, w: int) -> list:
    """Forward multiply-adds of one row, layer by layer in the order they
    run: the downs outermost first, then the ups innermost first (a
    transposed convolution per input pixel)."""
    lv = levels(in_nc, out_nc, cfg)
    last = len(lv) - 1
    down, up = [], []
    for i, (_, cin, inner, cout) in enumerate(lv):
        pix = (h >> (i + 1)) * (w >> (i + 1))         # the down's output, the up's input
        down.append(pix * cin * inner * 16)
        up.append(pix * (inner if i == last else 2 * inner) * cout * 16)
    return down + up[::-1]


def calls(c, cfg: dict, rows: int, backward: bool) -> None:
    """The C-entry calls of one apply (``work/calls.py`` says what counts):
    the instance norms alone, on the down of every level but the innermost
    and the outermost and on the up of every level but the outermost (13
    for ``unet_256``, 11 for ``unet_128``), each with its VJP where a
    backward runs. Every U-Net convolution is the library's."""
    h, w = cfg["crop_height"], cfg["crop_width"]
    last = depth(cfg) - 1
    for i, (_, _, inner, cout) in enumerate(levels(1, 1, cfg)):
        planes = []
        if 0 < i < last:
            planes.append(inner * (h >> (i + 1)) * (w >> (i + 1)))     # the down's output
        if i > 0:
            planes.append(cout * (h >> i) * (w >> i))                  # the up's output
        for plane in planes:
            c.norm("cg_instance_norm_act", rows * plane, 2)            # x -> y
            if backward:
                c.norm("cg_instance_norm_act_bwd", rows * plane, 3)    # x, dy -> dx
