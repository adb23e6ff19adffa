"""The networks, written out: ResNet generator and 70x70 PatchGAN.

Activations are NCHW float32. Parameters are a dict ``name -> tensor`` in
torch layout (convolutions OIHW, transposed convolutions (I, O, kH, kW));
:func:`generator_spec` and :func:`patchgan_spec` list their names and
shapes, the names the benchmark loads into the program's modules.

Generator (CycleGAN's ResNet, n blocks): reflect-pad 3 + 7x7 conv to ngf,
IN, ReLU; two 3x3 stride-2 zero-pad-1 convs to 2ngf and 4ngf, each IN +
ReLU; n blocks of [reflect-pad 1, 3x3 conv, IN, ReLU, (dropout 0.5),
reflect-pad 1, 3x3 conv, IN] + input; two 3x3 stride-2 transposed convs
(padding 1, output padding 1) to 2ngf and ngf, each IN + ReLU;
reflect-pad 3 + 7x7 conv to the output; tanh on the image generator, raw
logits on the label generator. PatchGAN: 4x4 zero-pad-1 convs C64 (stride
2, no norm), C128, C256 (stride 2), C512 (stride 1), each IN but the first,
LeakyReLU 0.2 after each, then a 4x4 stride-1 conv to one channel.
Instance norm: biased variance, eps 1e-5, no affine.

Dropout (frozen copy of the draw rule): a block's keep-mask is
``torch.rand((N, H, W, C), generator=g, device=g.device) >= 0.5`` (NHWC,
then read as NCHW); kept values are scaled by 2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.precision import EXACT

DROP_P = 0.5
EPS = 1e-5


def generator_spec(in_nc: int, out_nc: int, ngf: int, n_blocks: int) -> list:
    """[(name, shape)] of a ResNet generator's parameters, in the order of
    the module's registration."""
    spec = []

    def conv(name, cin, cout, k):
        spec.extend([(f"{name}.conv.weight", (cout, cin, k, k)), (f"{name}.conv.bias", (cout,))])

    def deconv(name, cin, cout, k):
        spec.extend([(f"{name}.conv.weight", (cin, cout, k, k)), (f"{name}.conv.bias", (cout,))])

    conv("stem", in_nc, ngf, 7)
    conv("down1", ngf, 2 * ngf, 3)
    conv("down2", 2 * ngf, 4 * ngf, 3)
    for i in range(n_blocks):
        conv(f"trunk.{i}.conv0", 4 * ngf, 4 * ngf, 3)
        conv(f"trunk.{i}.conv1", 4 * ngf, 4 * ngf, 3)
    deconv("up1", 4 * ngf, 2 * ngf, 3)
    deconv("up2", 2 * ngf, ngf, 3)
    conv("head", ngf, out_nc, 7)
    return spec


def patchgan_spec(in_nc: int, ndf: int, n_layers: int) -> list:
    """[(name, shape)] of a PatchGAN's parameters."""
    chans = [in_nc] + [min(ndf * 2 ** i, ndf * 8) for i in range(n_layers + 1)] + [1]
    spec = []
    for k in range(len(chans) - 1):
        spec.extend([(f"blocks.{k}.conv.weight", (chans[k + 1], chans[k], 4, 4)),
                     (f"blocks.{k}.conv.bias", (chans[k + 1],))])
    return spec


def n_blocks_of(gen_net: str) -> int:
    if not (gen_net.startswith("resnet_") and gen_net.endswith("blocks")):
        raise ValueError(f"the reference has the ResNet generators only, not {gen_net!r}")
    return int(gen_net[len("resnet_"):-len("blocks")])


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def reflect(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def dropout_keep(shape_nchw, generator: torch.Generator) -> torch.Tensor:
    """The keep-mask of one dropout call (the frozen draw rule)."""
    n, c, h, w = shape_nchw
    keep = torch.rand((n, h, w, c), generator=generator, device=generator.device) >= DROP_P
    return keep.permute(0, 3, 1, 2)


def generator(p: dict, x: torch.Tensor, n_blocks: int, tanh: bool, q=EXACT,
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
    for i in range(n_blocks):
        a = torch.relu(instance_norm(conv(f"trunk.{i}.conv0", reflect(h, 1))))
        if drop is not None:
            keep = dropout_keep(a.shape, drop)
            a = torch.where(keep, a / (1 - DROP_P), torch.zeros((), device=a.device))
        h = h + instance_norm(conv(f"trunk.{i}.conv1", reflect(a, 1)))
    h = torch.relu(instance_norm(deconv("up1", h)))
    h = torch.relu(instance_norm(deconv("up2", h)))
    h = conv("head", reflect(h, 3))
    return torch.tanh(h) if tanh else h


def patchgan(p: dict, x: torch.Tensor, n_layers: int, q=EXACT) -> torch.Tensor:
    """The PatchGAN's raw score map of NCHW ``x``."""
    def conv(k, h, stride):
        return q.conv2d(h, p[f"blocks.{k}.conv.weight"], p[f"blocks.{k}.conv.bias"], stride, 1)

    h = leaky(conv(0, x, 2))
    for k in range(1, n_layers):
        h = leaky(instance_norm(conv(k, h, 2)))
    h = leaky(instance_norm(conv(n_layers, h, 1)))
    return conv(n_layers + 1, h, 1)
