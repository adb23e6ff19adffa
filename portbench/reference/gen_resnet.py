"""The ResNet generator family (``resnet_<n>blocks``), CycleGAN's generator.

Reflect-pad 3 + 7x7 conv to ngf, IN, ReLU; two 3x3 stride-2 zero-pad-1
convs to 2ngf and 4ngf, each IN + ReLU; n blocks of [reflect-pad 1, 3x3
conv, IN, ReLU, (dropout 0.5), reflect-pad 1, 3x3 conv, IN] + input; two
3x3 stride-2 transposed convs (padding 1, output padding 1) to 2ngf and
ngf, each IN + ReLU; reflect-pad 3 + 7x7 conv to the output; tanh on the
image generator, raw logits on the label generator. The family contract is
in :mod:`portbench.reference.nets`.
"""

from __future__ import annotations

import torch

from portbench.reference.nets import dropout, instance_norm, reflect
from portbench.reference.precision import EXACT
from portbench.work.calls import BF16


def n_blocks_of(gen_net: str) -> int:
    if not (gen_net.startswith("resnet_") and gen_net.endswith("blocks")):
        raise ValueError(f"{gen_net!r} is no ResNet generator (resnet_<n>blocks)")
    return int(gen_net[len("resnet_"):-len("blocks")])


def spec(in_nc: int, out_nc: int, cfg: dict) -> list:
    """[(name, shape)] of a ResNet generator's parameters, in the order of
    the module's registration."""
    ngf, n_blocks = cfg["ngf"], n_blocks_of(cfg["gen_net"])
    out = []

    def conv(name, cin, cout, k):
        out.extend([(f"{name}.conv.weight", (cout, cin, k, k)), (f"{name}.conv.bias", (cout,))])

    def deconv(name, cin, cout, k):
        out.extend([(f"{name}.conv.weight", (cin, cout, k, k)), (f"{name}.conv.bias", (cout,))])

    conv("stem", in_nc, ngf, 7)
    conv("down1", ngf, 2 * ngf, 3)
    conv("down2", 2 * ngf, 4 * ngf, 3)
    for i in range(n_blocks):
        conv(f"trunk.{i}.conv0", 4 * ngf, 4 * ngf, 3)
        conv(f"trunk.{i}.conv1", 4 * ngf, 4 * ngf, 3)
    deconv("up1", 4 * ngf, 2 * ngf, 3)
    deconv("up2", 2 * ngf, ngf, 3)
    conv("head", ngf, out_nc, 7)
    return out


def forward(p: dict, x: torch.Tensor, cfg: dict, tanh: bool, q=EXACT,
            drop: torch.Generator | None = None) -> torch.Tensor:
    """The ResNet generator on NCHW ``x``; ``drop``: the dropout masks'
    generator (None: no dropout)."""
    def conv(name, h, stride=1, padding=0):
        return q.conv2d(h, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"], stride, padding)

    def deconv(name, h):
        return q.conv_transpose2d(h, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"])

    h = torch.relu(instance_norm(conv("stem", reflect(x, 3))))
    h = torch.relu(instance_norm(conv("down1", h, 2, 1)))
    h = torch.relu(instance_norm(conv("down2", h, 2, 1)))
    for i in range(n_blocks_of(cfg["gen_net"])):
        a = torch.relu(instance_norm(conv(f"trunk.{i}.conv0", reflect(h, 1))))
        if drop is not None:
            a = dropout(a, drop)
        h = h + instance_norm(conv(f"trunk.{i}.conv1", reflect(a, 1)))
    h = torch.relu(instance_norm(deconv("up1", h)))
    h = torch.relu(instance_norm(deconv("up2", h)))
    h = conv("head", reflect(h, 3))
    return torch.tanh(h) if tanh else h


def macs(in_nc: int, out_nc: int, cfg: dict, h: int, w: int) -> list:
    """Forward multiply-adds of one row, layer by layer (stem first)."""
    ngf, n_blocks = cfg["ngf"], n_blocks_of(cfg["gen_net"])
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    return ([h * w * in_nc * ngf * 49,                      # stem 7x7
             h2 * w2 * ngf * 2 * ngf * 9,                   # down1 3x3 s2
             h4 * w4 * 2 * ngf * 4 * ngf * 9]               # down2 3x3 s2
            + [h4 * w4 * 4 * ngf * 4 * ngf * 9] * (2 * n_blocks)   # trunk 3x3
            + [h4 * w4 * 4 * ngf * 2 * ngf * 9,             # up1, per input pixel
               h2 * w2 * 2 * ngf * ngf * 9,                 # up2
               h * w * ngf * out_nc * 49])                  # head 7x7


def calls(c, cfg: dict, rows: int, backward: bool) -> None:
    """The C-entry calls of one apply (``work/calls.py`` says what counts):
    the five norms outside the trunk, and each residual block's two
    convolutions and two norms, with their gradients and VJPs."""
    ngf, h, w = cfg["ngf"], cfg["crop_height"], cfg["crop_width"]
    outside = [(ngf, h, w), (2 * ngf, h // 2, w // 2), (4 * ngf, h // 4, w // 4),
               (2 * ngf, h // 2, w // 2), (ngf, h, w)]
    for ch, hh, ww in outside:
        e = rows * ch * hh * ww
        c.norm("cg_instance_norm_act", e, 2)                # x -> y
        if backward:
            c.norm("cg_instance_norm_act_bwd", e, 3)        # x, dy -> dx
    ch = 4 * ngf
    e = rows * ch * (h // 4) * (w // 4)
    conv = 2.0 * e * ch * 9
    weight = 9 * ch * ch
    for _ in range(n_blocks_of(cfg["gen_net"])):
        for _ in range(2):
            c.add("cg_conv3x3_reflect", conv, 2 * e * BF16 + weight * BF16)
        c.norm("cg_instance_norm_act", e, 2)                # u -> relu(IN(u))
        c.norm("cg_instance_norm_act", e, 3)                # s, x -> IN(s) + x
        if backward:
            for _ in range(2):
                c.add("cg_conv3x3_reflect_dgrad", conv, 2 * e * BF16 + weight * BF16)
                c.add("cg_conv_dw", conv, 2 * e * BF16 + weight * 4)
                c.norm("cg_instance_norm_act_bwd", e, 3)
