"""The port's serving artifact: a generator's weights and config on disk.

Counterpart of ``cyclegan_tpu/export.py``, whose artifact is a StableHLO
blob. The port's artifact for ``<out>`` is two files:

- ``<out>.pt``: ``{"format", "config", "state_dict", "scales"}``, where the
  config is ``gen_net``, ``ngf``, ``num_classes``, ``in_channels``,
  ``crop_hw``, the compute ``dtype``, ``input_dtype``, ``head``, ``norm``
  and ``quantize``; the state dict holds float32 tensors, or under
  ``quantize`` the large weights as int8 (with a float32 scale per output
  channel in ``scales``) or bfloat16 (loaded with ``weights_only=True``);
- ``<out>.json``: the manifest, with the JAX package's keys ``head``,
  ``dataset``, ``gen_net``, ``num_classes``, ``class_names``,
  ``trained_steps``, ``input_dtype`` and, when quantised, ``quantize``
  (``"<mode>_weight_only"``).

:func:`load_head` turns an artifact back into the function it serves:
``segment`` maps an NHWC image batch to uint8 class maps (the argmax of
the i2l generator's logits), ``logits`` to NHWC logits, ``generate`` an
(N, H, W) integer label map (255 = void) to an NHWC image in [-1, 1]
through the l2i generator's tanh head. A ``uint8`` input artifact takes
raw pixels and normalizes them on the device. Quantised weights are
dequantised once, when the artifact is loaded: ``bf16(f32(q) * s)`` is the
value the JAX package's per-call dequantisation gives.

:func:`run_export` is the CLI's ``--export``: it restores the newest
checkpoint of a run and writes the head it asks for.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch
from torch import nn

from cyclegan_tpu_torch.data.datasets import DATASET_SPECS, class_names
from cyclegan_tpu_torch.data.transforms import normalize
from cyclegan_tpu_torch.models.generators import define_Gen

FORMAT = "cyclegan_tpu_torch.generator/1"
HEADS = ("segment", "logits", "generate")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
QUANT_MODES = ("int8", "bf16")
QUANT_MIN_SIZE = 4096  # tensors smaller than this stay float32 (biases, norms)
IGNORE_INDEX = 255


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


# ------------------------------------------------------------ quantisation
def output_axes(module: nn.Module) -> dict[str, int]:
    """State-dict key -> output-channel axis of every conv weight: 0 of a
    conv's OIHW, 1 of a transposed conv's (I, O, kH, kW) (the last axis of
    the Flax HWIO kernel either way, where the JAX package takes its
    scales)."""
    return {f"{name}.weight" if name else "weight": int(isinstance(m, nn.ConvTranspose2d))
            for name, m in module.named_modules()
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))}


def quantize_array(x: np.ndarray, axis: int,
                   mode: str) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The JAX package's weight-only quantisation of one array (numpy,
    as ``cyclegan_tpu/export.py::quantize_weights``): ``int8`` = symmetric
    per-output-channel, scale ``max|w| / 127`` in float64 (0 -> 1), values
    ``round(w / scale)`` (half to even) clipped to +-127, the scale stored
    as float32, broadcastable along ``axis``; ``bf16`` = the value rounded
    to nearest even. Returns ``(stored tensor, scale or None)``."""
    if mode == "bf16":
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16), None
    flat = np.moveaxis(x, axis, -1).reshape(-1, x.shape[axis]).astype(np.float64)
    scale = np.max(np.abs(flat), axis=0) / 127.0
    scale = np.where(scale == 0.0, 1.0, scale)
    shape = [1] * x.ndim
    shape[axis] = -1
    scale = scale.reshape(shape)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return torch.from_numpy(q), torch.from_numpy(scale.astype(np.float32))


def quantize_state(state: dict[str, torch.Tensor], axes: dict[str, int], mode: str, *,
                   min_size: int = QUANT_MIN_SIZE
                   ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Quantise the float tensors of rank >= 2 and at least ``min_size``
    elements (the conv weights that make the artifact's size); the rest stay
    as they are. Returns ``(state dict, int8 scales by key)``."""
    out, scales = {}, {}
    for k, v in state.items():
        if v.dim() < 2 or v.numel() < min_size or not v.is_floating_point():
            out[k] = v
            continue
        out[k], s = quantize_array(v.float().numpy(), axes.get(k, 0), mode)
        if s is not None:
            scales[k] = s
    return out, scales


def dequantize_state(state: dict[str, torch.Tensor], scales: dict[str, torch.Tensor]
                     ) -> dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_state`: ``float32(q) * scale`` (a float32
    product, as the JAX ``dequantize_weights``) and bf16 -> float32."""
    return {k: v.float() * scales[k] if k in scales else v.float() for k, v in state.items()}


# ------------------------------------------------------------------ writing
def check_export_options(head: str, input_dtype: str = "float32",
                         quantize: str | None = None) -> None:
    """The options an artifact refuses, checked before anything is built."""
    if head not in HEADS:
        raise ValueError(f"unknown export head {head!r} (segment|logits|generate)")
    if input_dtype not in ("float32", "uint8"):
        raise ValueError(f"unknown input_dtype {input_dtype!r} (float32|uint8)")
    if head == "generate" and input_dtype == "uint8":
        raise ValueError("--export_input uint8 applies to the image-fed segment/logits "
                         "heads; the generate head already consumes int32 label maps")
    if quantize is not None and quantize not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {quantize!r} (int8|bf16)")


def export_generator(module: nn.Module, out_path: str, *, gen_net: str,
                     ngf: int, num_classes: int, in_channels: int,
                     crop_hw: tuple[int, int], dtype: str = "bfloat16",
                     head: str = "segment", input_dtype: str = "float32",
                     dataset: str = "voc2012", trained_steps: int = 0,
                     norm: str = "instance", quantize: str | None = None) -> str:
    """Write the artifact of a generator; returns the ``.pt`` path.

    ``module`` is the image->label generator (head ``none``) for the
    ``segment`` and ``logits`` heads and the label->image generator (head
    ``tanh``, ``num_classes`` in, ``in_channels`` out) for ``generate``.
    ``quantize``: ``int8`` or ``bf16`` weight-only quantisation (about 4x
    and 2x smaller)."""
    check_export_options(head, input_dtype, quantize)
    if dtype not in DTYPES:
        raise ValueError(f"unknown compute dtype {dtype!r} (float32|bfloat16)")
    pt_path, json_path = artifact_paths(out_path)
    os.makedirs(os.path.dirname(os.path.abspath(pt_path)), exist_ok=True)
    config = {"gen_net": gen_net, "ngf": ngf, "num_classes": num_classes,
              "in_channels": in_channels, "crop_hw": list(crop_hw), "dtype": dtype,
              "input_dtype": input_dtype, "head": head, "norm": norm, "quantize": quantize}
    state = {k: v.detach().to("cpu", torch.float32).contiguous()
             for k, v in module.state_dict().items()}
    scales: dict = {}
    if quantize:
        state, scales = quantize_state(state, output_axes(module), quantize)
    torch.save({"format": FORMAT, "config": config, "state_dict": state, "scales": scales},
               pt_path)
    manifest = {"head": head, "dataset": dataset, "gen_net": gen_net,
                "num_classes": num_classes,
                "class_names": list(class_names(dataset, num_classes)),
                "trained_steps": int(trained_steps), "input_dtype": input_dtype}
    if quantize:
        manifest["quantize"] = f"{quantize}_weight_only"
    with open(json_path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return pt_path


def run_export(cfg, out_path: str, *, semisupervised: bool = True, what: str = "segment",
               quantize: str | None = None, input_dtype: str = "float32",
               device: str | torch.device | None = None, num_classes: int | None = None,
               in_channels: int | None = None, weights_npz: str | None = None) -> str:
    """The CLI's ``--export``: restore the newest checkpoint under
    ``cfg.checkpoint_dir`` (``train.checkpoint.restore_for_inference``) and
    write the ``what`` head: ``segment`` or ``logits`` of the segmenter
    (G_i2l, or the supervised net), or ``generate``, the label->image
    generator G_l2i (semi-supervised checkpoints only). ``weights_npz``, a
    Flax G_i2l tree saved as an ``.npz`` (``params/...`` and, under batch
    norm, ``batch_stats/...``), takes the checkpoint's place. The compute
    type is ``cfg.bf16``'s, the window ``cfg.crop_hw``, the norm
    ``cfg.norm``; the manifest's ``trained_steps`` is the state's step.
    ``num_classes`` / ``in_channels`` override the dataset's (a run trained
    at other counts)."""
    check_export_options(what, input_dtype, quantize)
    if weights_npz:
        from cyclegan_tpu_torch.weights import load_flax_module, load_npz

        if what == "generate":
            raise ValueError("--weights_npz carries a G_i2l tree (segment|logits heads); "
                             "export the generate head from a checkpoint")
        spec_nc, spec_ic, _ = DATASET_SPECS[cfg.dataset]
        num_classes, in_ch = num_classes or spec_nc, in_channels or spec_ic
        module = define_Gen(in_ch, num_classes, cfg.ngf, cfg.gen_net, norm=cfg.norm,
                            head="none")
        load_flax_module(module, load_npz(weights_npz))
        step, source = 0, weights_npz
    else:
        from cyclegan_tpu_torch.train.checkpoint import restore_for_inference

        if what == "generate" and not semisupervised:
            raise ValueError("--export_what generate needs a semi-supervised checkpoint "
                             "(the l2i generator)")
        trainer, state, num_classes, in_ch = restore_for_inference(
            cfg, semisupervised=semisupervised, num_classes=num_classes,
            in_channels=in_channels, device=device)
        if what == "generate":
            module = trainer.G_l2i
        else:
            module = trainer.G_i2l if semisupervised else trainer.model
        step = int(state.step)
        source = f"step {step} of {cfg.checkpoint_dir}"
    path = export_generator(
        module, out_path, gen_net=cfg.gen_net, ngf=cfg.ngf, num_classes=num_classes,
        in_channels=in_ch, crop_hw=cfg.crop_hw, dtype="bfloat16" if cfg.bf16 else "float32",
        head=what, input_dtype=input_dtype, dataset=cfg.dataset, trained_steps=step,
        norm=cfg.norm, quantize=quantize)
    print(f"exported {what} head ({source}" + (f", {quantize} weights" if quantize else "")
          + f") -> {path}", flush=True)
    return path


# ------------------------------------------------------------------ loading
def load_artifact(path: str) -> tuple[dict, dict]:
    """(artifact dict, manifest) of ``<out>`` / ``<out>.pt``."""
    pt_path, json_path = artifact_paths(path)
    art = torch.load(pt_path, map_location="cpu", weights_only=True)
    if art.get("format") != FORMAT:
        raise ValueError(f"{pt_path}: not a {FORMAT} artifact")
    art["config"].setdefault("quantize", None)
    art.setdefault("scales", {})
    manifest = {}
    if os.path.exists(json_path):
        with open(json_path) as f:
            manifest = json.load(f)
    return art, manifest


def build_module(art: dict, device: torch.device) -> nn.Module:
    """The artifact's generator on ``device`` in eval mode: the weights
    dequantised (if quantised) to float32, then cast once to the compute
    dtype; activations in channels_last memory."""
    cfg = art["config"]
    dtype = DTYPES[cfg["dtype"]]
    if cfg["head"] == "generate":
        G = define_Gen(cfg["num_classes"], cfg["in_channels"], cfg["ngf"], cfg["gen_net"],
                       norm=cfg["norm"], head="tanh", dtype=dtype)
    else:
        G = define_Gen(cfg["in_channels"], cfg["num_classes"], cfg["ngf"], cfg["gen_net"],
                       norm=cfg["norm"], head="none", dtype=dtype)
    G.load_state_dict(dequantize_state(art["state_dict"], art["scales"]))
    return G.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()


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


def onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(N, H, W) labels -> (N, H, W, K) float32 one-hot, all zero on void
    (``CycleGANTrainer._onehot``)."""
    valid = labels != IGNORE_INDEX
    oh = nn.functional.one_hot(torch.where(valid, labels, 0).long(), num_classes)
    return oh.float() * valid[..., None]


def head_fn(G: Callable[[torch.Tensor], torch.Tensor], cfg: dict,
            device: torch.device) -> Callable:
    """The served function of an artifact's generator ``G`` (its module, or
    a function calling it; see :func:`load_head`)."""
    if cfg["head"] == "generate":
        k = cfg["num_classes"]
        return lambda labels: G(onehot(labels, k).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def logits(x: torch.Tensor) -> torch.Tensor:
        return G(x.permute(0, 3, 1, 2))  # NHWC memory = NCHW channels_last

    if cfg["head"] == "segment":
        fn = lambda x: torch.argmax(logits(x), dim=1)  # noqa: E731
        if cfg["num_classes"] <= 255:
            fn = uint8_output(fn)
    else:
        fn = lambda x: logits(x).permute(0, 2, 3, 1)  # noqa: E731
    if cfg["input_dtype"] == "uint8":
        fn = uint8_input(fn, device)
    return fn


def load_head(path: str, device: str | torch.device | None = None
              ) -> tuple[Callable[[torch.Tensor], torch.Tensor], dict, dict]:
    """Build the served function of an artifact on ``device``.

    Returns ``(fn, config, manifest)``; ``fn`` takes a batch on the device
    and returns, on the device: for ``segment``, (N, H, W) class indices
    (uint8 for <= 255 classes) of an NHWC image batch (float32 normalized,
    or uint8 for uint8-input artifacts); for ``logits``, (N, H, W, classes)
    logits; for ``generate``, the (N, H, W, C) image in [-1, 1] of an
    (N, H, W) integer label map.
    """
    dev = resolve_device(device)
    art, manifest = load_artifact(path)
    G = build_module(art, dev)
    return torch.inference_mode()(head_fn(G, art["config"], dev)), art["config"], manifest
