"""Carry Flax parameters into the port's modules.

The Flax ``ResnetGenerator`` tree (what ``jax.device_get(params)["params"]``
gives, as nested dicts of numpy arrays) names its layers ConvBlock_0..3,
ResidualBlock_i/ConvBlock_{0,1} and DeconvBlock_{0,1}; the PatchGAN and the
PixelDiscriminator name theirs ConvBlock_0..k in forward order (the mapping
of ``tests/parity_utils.py::inject_patchgan`` / ``inject_pixeld``). Each
layer has a ``kernel`` (HWIO) and a ``bias``. Conv kernels go HWIO -> OIHW, transposed
conv kernels HWIO -> (I, O, kH, kW) (the mapping of
``tools/export_torch_checkpoint.py``); biases are copied as they are. Any
missing, extra or misshapen entry raises.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from cyclegan_tpu_torch.models.discriminators import (NLayerDiscriminator,
                                                      PixelDiscriminator)
from cyclegan_tpu_torch.models.generators import ResnetGenerator


def _flax_layers(module: nn.Module) -> dict[str, Any]:
    """Flax name -> torch conv layer (or nested dict for a residual block)."""
    if isinstance(module, (NLayerDiscriminator, PixelDiscriminator)):
        return {f"ConvBlock_{k}": b.conv for k, b in enumerate(module.blocks)}
    if not isinstance(module, ResnetGenerator):
        raise TypeError(f"no Flax mapping for {type(module).__name__}")
    layers: dict[str, Any] = {"ConvBlock_0": module.stem.conv,
                              "ConvBlock_1": module.down1.conv,
                              "ConvBlock_2": module.down2.conv}
    for i, block in enumerate(module.trunk):
        layers[f"ResidualBlock_{i}"] = {"ConvBlock_0": block.conv0.conv,
                                        "ConvBlock_1": block.conv1.conv}
    layers["DeconvBlock_0"] = module.up1.conv
    layers["DeconvBlock_1"] = module.up2.conv
    layers["ConvBlock_3"] = module.head.conv
    return layers


def _check_names(have: Mapping, want: Mapping, where: str) -> None:
    if set(have) != set(want):
        missing, extra = sorted(set(want) - set(have)), sorted(set(have) - set(want))
        raise KeyError(f"{where or 'params'}: missing {missing}, unexpected {extra}")


def _copy(dst: torch.Tensor, src: np.ndarray, where: str) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: shape {tuple(src.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))


def _load_layer(conv: nn.Module, leaf: Mapping, where: str) -> None:
    want = {"kernel": None, "bias": None} if conv.bias is not None else {"kernel": None}
    _check_names(leaf, want, where)
    k = np.asarray(leaf["kernel"])
    if k.ndim != 4:
        raise ValueError(f"{where}/kernel: want a 4-D HWIO kernel, got {k.shape}")
    if isinstance(conv, nn.ConvTranspose2d):
        k = k.transpose(2, 3, 0, 1)   # HWIO -> (I, O, kH, kW)
    else:
        k = k.transpose(3, 2, 0, 1)   # HWIO -> (O, I, kH, kW)
    _copy(conv.weight, k, f"{where}/kernel")
    if conv.bias is not None:
        _copy(conv.bias, np.asarray(leaf["bias"]), f"{where}/bias")


def load_flax_module(module: nn.Module, params: Mapping) -> nn.Module:
    """Copy a Flax param tree of a ResnetGenerator, NLayerDiscriminator or
    PixelDiscriminator into ``module`` (in place); returns ``module``."""

    def walk(layers: Mapping, tree: Mapping, where: str) -> None:
        _check_names(tree, layers, where)
        for name, dst in layers.items():
            path = f"{where}/{name}" if where else name
            if isinstance(dst, dict):
                walk(dst, tree[name], path)
            else:
                _load_layer(dst, tree[name], path)

    walk(_flax_layers(module), params, "")
    return module


CYCLEGAN_NETS = (("g_i2l", "G_i2l"), ("g_l2i", "G_l2i"), ("d_img", "D_img"),
                 ("d_lab", "D_lab"))


def load_flax_cyclegan(trainer: Any, state: Any) -> Any:
    """Copy the four nets of a JAX ``CycleGANState`` (or a mapping with the
    keys g_i2l, g_l2i, d_img, d_lab; each a Flax variables dict or its
    ``params``) into ``trainer``'s modules, in place; returns ``trainer``.
    Build the optimizers before or after: they hold the same parameters."""
    for key, attr in CYCLEGAN_NETS:
        tree = state[key] if isinstance(state, Mapping) else getattr(state, key)
        if isinstance(tree, Mapping) and set(tree) == {"params"}:
            tree = tree["params"]
        load_flax_module(getattr(trainer, attr), tree)
    return trainer


def load_npz(path: str) -> dict:
    """Read a Flax param tree saved as an ``.npz`` with '/'-joined keys
    (``ResidualBlock_0/ConvBlock_1/kernel``) back into nested dicts."""
    tree: dict = {}
    with np.load(path) as f:
        for key in f.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = f[key]
    return tree
