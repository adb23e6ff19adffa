"""The networks, written out: the 70x70 PatchGAN, the pieces every network
shares, and the generator families found by name.

Activations are NCHW float32. Parameters are a dict ``name -> tensor`` in
torch layout (convolutions OIHW, transposed convolutions (I, O, kH, kW)); a
``spec`` lists their names and shapes, the names the benchmark loads into
the program's modules.

Generators come in families, one file each: ``gen_<family>.py`` beside
this one, where the family is the ``gen_net`` prefix before its first
``_`` (``resnet_9blocks`` -> ``gen_resnet.py``, ``unet_256`` ->
``gen_unet.py``). :func:`family` loads it. A family file exports

- ``spec(in_nc, out_nc, cfg)``: [(name, shape)] of the generator's
  parameters, in the port module's registration order and under its names;
- ``forward(p, x, cfg, tanh, q=EXACT, drop=None)``: the generator on NCHW
  float32 ``x``, its convolutions through ``q`` (:mod:`.precision`), its
  dropout masks drawn from ``drop`` by :func:`dropout_keep` (None: no
  dropout), tanh or raw logits on the head;
- ``macs(in_nc, out_nc, cfg, h, w)``: forward multiply-adds of one row at
  h x w, layer by layer, first layer first (``work.model.pass_flops``);
- ``calls(c, cfg, rows, backward)``: adds to ``c`` (``work.calls.Calls``)
  the calls of the port's C entries that one apply of ``rows`` rows needs,
  with its backward where ``backward``.

A family file imports nothing of the port and nothing of JAX.

PatchGAN: 4x4 zero-pad-1 convs C64 (stride 2, no norm), C128, C256 (stride
2), C512 (stride 1), each IN but the first, LeakyReLU 0.2 after each, then
a 4x4 stride-1 conv to one channel. Instance norm: biased variance, eps
1e-5, no affine.

Dropout (frozen copy of the draw rule): a call's keep-mask is
``torch.rand((N, H, W, C), generator=g, device=g.device) >= 0.5`` (NHWC,
then read as NCHW); kept values are scaled by 2.
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

from portbench.reference.precision import EXACT

DROP_P = 0.5
EPS = 1e-5


def family(gen_net: str):
    """The module of ``gen_net``'s generator family (``gen_<prefix>.py``)."""
    name = gen_net.split("_", 1)[0]
    try:
        return importlib.import_module(f"portbench.reference.gen_{name}")
    except ModuleNotFoundError as e:
        if e.name != f"portbench.reference.gen_{name}":
            raise
        raise ValueError(f"the reference has no generator family {name!r} "
                         f"(portbench/reference/gen_{name}.py) for {gen_net!r}") from None


def patchgan_spec(in_nc: int, ndf: int, n_layers: int) -> list:
    """[(name, shape)] of a PatchGAN's parameters."""
    chans = [in_nc] + [min(ndf * 2 ** i, ndf * 8) for i in range(n_layers + 1)] + [1]
    spec = []
    for k in range(len(chans) - 1):
        spec.extend([(f"blocks.{k}.conv.weight", (chans[k + 1], chans[k], 4, 4)),
                     (f"blocks.{k}.conv.bias", (chans[k + 1],))])
    return spec


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


def dropout(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout of ``x`` under a mask drawn by :func:`dropout_keep`."""
    keep = dropout_keep(x.shape, generator)
    return torch.where(keep, x / (1 - DROP_P), torch.zeros((), device=x.device))


def patchgan(p: dict, x: torch.Tensor, n_layers: int, q=EXACT) -> torch.Tensor:
    """The PatchGAN's raw score map of NCHW ``x``."""
    def conv(k, h, stride):
        return q.conv2d(h, p[f"blocks.{k}.conv.weight"], p[f"blocks.{k}.conv.bias"], stride, 1)

    h = leaky(conv(0, x, 2))
    for k in range(1, n_layers):
        h = leaky(instance_norm(conv(k, h, 2)))
    h = leaky(instance_norm(conv(n_layers, h, 1)))
    return conv(n_layers + 1, h, 1)
