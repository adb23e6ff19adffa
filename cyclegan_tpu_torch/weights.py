"""Carry Flax variables into the port's modules, and back.

The Flax ``ResnetGenerator`` tree (what ``jax.device_get(params)["params"]``
gives, as nested dicts of numpy arrays) names its layers ConvBlock_0..3,
ResidualBlock_i/ConvBlock_{0,1} and DeconvBlock_{0,1}; the PatchGAN and the
PixelDiscriminator name theirs ConvBlock_0..k in forward order (the mapping
of ``tests/parity_utils.py::inject_patchgan`` / ``inject_pixeld``). Each
layer has a ``kernel`` (HWIO) and a ``bias``. The ``UnetGenerator`` names
its levels ``_UnetBlock_0`` (innermost) up to the outermost, each with
``down_kernel``, ``down_bias``, ``up_kernel`` and ``up_bias`` (the nesting
of ``tests/parity_utils.py::inject_unet``). Conv kernels go HWIO -> OIHW,
transposed conv kernels HWIO -> (I, O, kH, kW) (the mapping of
``tools/export_torch_checkpoint.py``); biases are copied as they are.

Under ``norm='batch'`` a layer's norm is ``BatchNorm_0`` beside its kernel
(a U-Net level: ``BatchNorm_0`` for the down norm where the level has one,
then the up norm): ``scale`` and ``bias`` in ``params``, ``mean`` and ``var``
in the ``batch_stats`` collection, which go to the port's ``BatchNorm``
weight, bias and running buffers. Any missing, extra or misshapen entry
raises.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from cyclegan_tpu_torch.models.discriminators import (NLayerDiscriminator,
                                                      PixelDiscriminator)
from cyclegan_tpu_torch.models.generators import ResnetGenerator, UnetGenerator
from cyclegan_tpu_torch.ops.blocks import BatchNorm

Path = tuple[str, ...]
# How a Flax array is laid out for its torch tensor: a conv kernel (HWIO <->
# OIHW), a transposed conv kernel (HWIO <-> (I, O, kH, kW)), or as it is.
_PERM = {"conv": (3, 2, 0, 1), "deconv": (2, 3, 0, 1)}
_PERM_BACK = {"conv": (2, 3, 1, 0), "deconv": (2, 3, 0, 1)}


def _flax_blocks(module: nn.Module) -> dict[str, Any]:
    """Flax name -> ConvBlock or DeconvBlock (or nested dict for a residual
    block) of a ResNet generator or a discriminator."""
    if isinstance(module, (NLayerDiscriminator, PixelDiscriminator)):
        return {f"ConvBlock_{k}": b for k, b in enumerate(module.blocks)}
    if not isinstance(module, ResnetGenerator):
        raise TypeError(f"no Flax mapping for {type(module).__name__}")
    blocks: dict[str, Any] = {"ConvBlock_0": module.stem, "ConvBlock_1": module.down1,
                              "ConvBlock_2": module.down2}
    for i, block in enumerate(module.trunk):
        blocks[f"ResidualBlock_{i}"] = {"ConvBlock_0": block.conv0, "ConvBlock_1": block.conv1}
    blocks["DeconvBlock_0"] = module.up1
    blocks["DeconvBlock_1"] = module.up2
    blocks["ConvBlock_3"] = module.head
    return blocks


def _flax_layers(module: nn.Module) -> dict[str, Any]:
    """Flax name -> torch conv layer (or nested dict for a residual block)."""

    def convs(tree):
        return {k: convs(v) if isinstance(v, dict) else v.conv for k, v in tree.items()}

    return convs(_flax_blocks(module))


def _conv(path: Path, conv: nn.Module, prefix: str = "") -> dict:
    layout = "deconv" if isinstance(conv, nn.ConvTranspose2d) else "conv"
    out = {path + (prefix + "kernel",): (conv.weight, layout)}
    if conv.bias is not None:
        out[path + (prefix + "bias",)] = (conv.bias, "vec")
    return out


def _bn(path: Path, norm: nn.Module | None) -> tuple[dict, dict]:
    if not isinstance(norm, BatchNorm):
        return {}, {}
    return ({path + ("scale",): (norm.weight, "vec"), path + ("bias",): (norm.bias, "vec")},
            {path + ("mean",): (norm.running_mean, "vec"),
             path + ("var",): (norm.running_var, "vec")})


def flax_targets(module: nn.Module) -> tuple[dict, dict]:
    """``(params, batch_stats)``: Flax path -> (torch tensor, layout) of every
    array of ``module``'s Flax variables."""
    params: dict = {}
    stats: dict = {}

    def add_norms(path: Path, norms: list) -> None:
        for k, norm in enumerate(n for n in norms if isinstance(n, BatchNorm)):
            p, s = _bn(path + (f"BatchNorm_{k}",), norm)
            params.update(p)
            stats.update(s)

    if isinstance(module, UnetGenerator):
        for k, level in enumerate(module.levels()):
            path = (f"_UnetBlock_{k}",)
            params.update(_conv(path, level.down, "down_"))
            params.update(_conv(path, level.up, "up_"))
            add_norms(path, [level.down_norm, level.up_norm])
        return params, stats

    def walk(tree: Mapping, path: Path) -> None:
        for name, block in tree.items():
            if isinstance(block, dict):
                walk(block, path + (name,))
            else:
                params.update(_conv(path + (name,), block.conv))
                add_norms(path + (name,), [block.norm])

    walk(_flax_blocks(module), ())
    return params, stats


def _flatten(tree: Mapping, path: Path = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + (str(k),)))
        else:
            out[path + (str(k),)] = v
    return out


def _check_names(have: Mapping, want: Mapping, where: str) -> None:
    if set(have) != set(want):
        def names(paths):
            return sorted("/".join(p) if isinstance(p, tuple) else p for p in paths)

        missing, extra = names(set(want) - set(have)), names(set(have) - set(want))
        raise KeyError(f"{where or 'params'}: missing {missing}, unexpected {extra}")


def _copy(dst: torch.Tensor, src: np.ndarray, where: str) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: shape {tuple(src.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))


def _load(dst: torch.Tensor, layout: str, src: Any, where: str) -> None:
    a = np.asarray(src)
    if layout != "vec":
        if a.ndim != 4:
            raise ValueError(f"{where}: want a 4-D HWIO kernel, got {a.shape}")
        a = a.transpose(_PERM[layout])
    _copy(dst, a, where)


def _load_layer(conv: nn.Module, leaf: Mapping, where: str) -> None:
    """Copy one Flax ``{kernel, bias}`` leaf into a conv layer."""
    targets = {k[-1]: v for k, v in _conv((), conv).items()}
    _check_names(leaf, targets, where)
    for name, (dst, layout) in targets.items():
        _load(dst, layout, leaf[name], f"{where}/{name}")


def _load_collection(targets: dict, tree: Mapping, what: str) -> None:
    flat = _flatten(tree)
    _check_names(flat, targets, what)
    for path, (dst, layout) in targets.items():
        _load(dst, layout, flat[path], "/".join(path))


def load_flax_module(module: nn.Module, params: Mapping,
                     batch_stats: Mapping | None = None) -> nn.Module:
    """Copy a Flax param tree of a ResnetGenerator, UnetGenerator,
    NLayerDiscriminator or PixelDiscriminator into ``module`` (in place);
    ``params`` may also be the whole variables dict (``params`` and, under
    batch norm, ``batch_stats``). ``batch_stats`` goes to the batch norms'
    running buffers; without it they stay as they are. Returns ``module``."""
    if set(params) <= {"params", "batch_stats"} and "params" in params:
        batch_stats = params.get("batch_stats", batch_stats)
        params = params["params"]
    p_targets, s_targets = flax_targets(module)
    _load_collection(p_targets, params, "params")
    if batch_stats is not None:
        _load_collection(s_targets, batch_stats, "batch_stats")
    return module


def flax_variables(module: nn.Module) -> dict:
    """The Flax variables of ``module`` as nested dicts of float32 numpy
    arrays: ``{"params": ...}``, and ``"batch_stats"`` under batch norm (the
    way back of :func:`load_flax_module`)."""
    out: dict = {}
    for coll, targets in zip(("params", "batch_stats"), flax_targets(module)):
        for path, (src, layout) in targets.items():
            a = src.detach().float().cpu()
            if layout != "vec":
                a = a.permute(_PERM_BACK[layout])
            node = out.setdefault(coll, {})
            for name in path[:-1]:
                node = node.setdefault(name, {})
            node[path[-1]] = a.numpy().copy()
    return out


CYCLEGAN_NETS = (("g_i2l", "G_i2l"), ("g_l2i", "G_l2i"), ("d_img", "D_img"),
                 ("d_lab", "D_lab"))


def load_flax_cyclegan(trainer: Any, state: Any) -> Any:
    """Copy the four nets of a JAX ``CycleGANState`` (or a mapping with the
    keys g_i2l, g_l2i, d_img, d_lab; each a Flax variables dict or its
    ``params``) into ``trainer``'s modules, in place; returns ``trainer``.
    Build the optimizers before or after: they hold the same parameters."""
    for key, attr in CYCLEGAN_NETS:
        tree = state[key] if isinstance(state, Mapping) else getattr(state, key)
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
