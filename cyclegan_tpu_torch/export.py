"""The port's serving artifact: a generator's weights and config on disk.

Counterpart of ``cyclegan_tpu/export.py``, whose artifact is a StableHLO
blob. The port's artifact for ``<out>`` is two files:

- ``<out>.pt``: ``{"format", "config", "state_dict"}``, where the config is
  ``gen_net``, ``ngf``, ``num_classes``, ``in_channels``, ``crop_hw``, the
  compute ``dtype``, ``input_dtype``, ``head`` and ``norm``, and the state
  dict holds float32 tensors (loaded with ``weights_only=True``);
- ``<out>.json``: the manifest, with the JAX package's keys ``head``,
  ``dataset``, ``gen_net``, ``num_classes``, ``class_names``,
  ``trained_steps`` and ``input_dtype``.

:func:`load_head` turns an artifact back into the function it serves:
``segment`` maps an NHWC image batch to uint8 class maps (the argmax of
the i2l generator's logits), ``logits`` to NHWC logits. A ``uint8`` input
artifact takes raw pixels and normalizes them on the device.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

from cyclegan_tpu_torch.data.datasets import class_names
from cyclegan_tpu_torch.data.transforms import normalize
from cyclegan_tpu_torch.models.generators import define_Gen

FORMAT = "cyclegan_tpu_torch.generator/1"
HEADS = ("segment", "logits")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA device; a CUDA device that is absent raises
    (the CPU is used only when asked for)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def artifact_paths(path: str) -> tuple[str, str]:
    """``<out>`` or ``<out>.pt`` -> (``<out>.pt``, ``<out>.json``)."""
    stem = path[:-3] if path.endswith(".pt") else path
    return stem + ".pt", stem + ".json"


def export_generator(module: torch.nn.Module, out_path: str, *, gen_net: str,
                     ngf: int, num_classes: int, in_channels: int,
                     crop_hw: tuple[int, int], dtype: str = "bfloat16",
                     head: str = "segment", input_dtype: str = "float32",
                     dataset: str = "voc2012", trained_steps: int = 0,
                     norm: str = "instance") -> str:
    """Write the artifact of an image->label generator (head ``none``);
    returns the ``.pt`` path."""
    if head not in HEADS:
        raise ValueError(f"unknown export head {head!r} (segment|logits)")
    if input_dtype not in ("float32", "uint8"):
        raise ValueError(f"unknown input_dtype {input_dtype!r} (float32|uint8)")
    if dtype not in DTYPES:
        raise ValueError(f"unknown compute dtype {dtype!r} (float32|bfloat16)")
    pt_path, json_path = artifact_paths(out_path)
    os.makedirs(os.path.dirname(os.path.abspath(pt_path)), exist_ok=True)
    config = {"gen_net": gen_net, "ngf": ngf, "num_classes": num_classes,
              "in_channels": in_channels, "crop_hw": list(crop_hw), "dtype": dtype,
              "input_dtype": input_dtype, "head": head, "norm": norm}
    state = {k: v.detach().to("cpu", torch.float32).contiguous()
             for k, v in module.state_dict().items()}
    torch.save({"format": FORMAT, "config": config, "state_dict": state}, pt_path)
    manifest = {"head": head, "dataset": dataset, "gen_net": gen_net,
                "num_classes": num_classes,
                "class_names": list(class_names(dataset, num_classes)),
                "trained_steps": int(trained_steps), "input_dtype": input_dtype}
    with open(json_path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return pt_path


def load_artifact(path: str) -> tuple[dict, dict]:
    """(artifact dict, manifest) of ``<out>`` / ``<out>.pt``."""
    pt_path, json_path = artifact_paths(path)
    art = torch.load(pt_path, map_location="cpu", weights_only=True)
    if art.get("format") != FORMAT:
        raise ValueError(f"{pt_path}: not a {FORMAT} artifact")
    manifest = {}
    if os.path.exists(json_path):
        with open(json_path) as f:
            manifest = json.load(f)
    return art, manifest


def uint8_input(fn: Callable, device: torch.device) -> Callable:
    """Wrap ``fn`` to take raw uint8 pixels and normalize them on the device
    through a 256-entry table built by the host ``normalize`` itself, so the
    values are bit-identical to a float32 artifact's input (an on-device
    ``x / 127.5 - 1`` may round differently and flip near-tie argmaxes)."""
    lut = torch.from_numpy(normalize(np.arange(256, dtype=np.uint8))).to(device)
    return lambda x: fn(lut[x.long()])


def uint8_output(fn: Callable) -> Callable:
    """Cast a class-map function's result to uint8 on the device (lossless
    for <= 255 classes; the host fetches 1 byte per pixel)."""
    return lambda x: fn(x).to(torch.uint8)


def load_head(path: str, device: str | torch.device | None = None
              ) -> tuple[Callable[[torch.Tensor], torch.Tensor], dict, dict]:
    """Build the served function of an artifact on ``device``.

    Returns ``(fn, config, manifest)``; ``fn`` takes an NHWC batch on the
    device (float32 normalized, or uint8 for uint8-input artifacts) and
    returns (N, H, W) class indices (``segment``; uint8 for <= 255 classes)
    or (N, H, W, classes) logits (``logits``), on the device.
    """
    dev = resolve_device(device)
    art, manifest = load_artifact(path)
    cfg = art["config"]
    dtype = DTYPES[cfg["dtype"]]
    G = define_Gen(cfg["in_channels"], cfg["num_classes"], cfg["ngf"], cfg["gen_net"],
                   norm=cfg["norm"], head="none", dtype=dtype)
    G.load_state_dict(art["state_dict"])
    # Weights are cast to the compute dtype once (the values a per-call
    # cast would give); activations live in channels_last memory.
    G = G.to(device=dev, dtype=dtype, memory_format=torch.channels_last).eval()

    def logits(x: torch.Tensor) -> torch.Tensor:
        return G(x.permute(0, 3, 1, 2))  # NHWC memory = NCHW channels_last

    if cfg["head"] == "segment":
        fn = lambda x: torch.argmax(logits(x), dim=1)  # noqa: E731
        if cfg["num_classes"] <= 255:
            fn = uint8_output(fn)
    else:
        fn = lambda x: logits(x).permute(0, 2, 3, 1)  # noqa: E731
    if cfg["input_dtype"] == "uint8":
        fn = uint8_input(fn, dev)
    return torch.inference_mode()(fn), cfg, manifest
