"""Typed config and the five presets.

A copy of ``cyclegan_tpu/utils/config.py`` (the port may not import the JAX
package): the same fields, defaults and presets, so ``preset(name)`` names
the same configuration in both. Flag names mirror the reference's argparse
surface. Fields the port does not use yet (the runner, loaders, parallel
and observability settings) are kept so a config moves between the two
unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass
class Config:
    # model
    gen_net: str = "resnet_9blocks"
    dis_net: str = "n_layers"
    n_layers_D: int = 3
    ngf: int = 64
    ndf: int = 64
    norm: str = "instance"
    use_dropout: bool = False

    # optimization (reference defaults: lr 2e-4, betas (0.5, 0.999), lamda
    # 10, 200 epochs with decay from epoch 100, pool size 50)
    epochs: int = 200
    decay_epoch: int = 100
    batch_size: int = 1
    lr: float = 2e-4
    lamda: float = 10.0          # cycle-consistency weight (reference flag name)
    lamda_lab: float | None = None  # label-cycle CE weight; None -> lamda
    pool_size: int = 50
    labeled_fraction: float = 0.125
    # "zip": an epoch ends with the shorter (labeled) stream, the
    # reference's pairing; "cycle": the unlabeled stream sets the epoch.
    pairing: str = "zip"

    # data
    dataset: str = "voc2012"
    data_root: str | None = None
    loader: str = "native"             # native | grain
    loader_workers: int = 0
    crop_height: int = 256
    crop_width: int = 256
    # Optional fixed resize before the random crop.
    resize_height: int | None = None
    resize_width: int | None = None
    # Val/test image shaping: "resize" | "center_crop" | "tile".
    eval_resize: str = "resize"
    eval_flip: bool = False            # horizontal-flip test-time augmentation
    eval_scales: str | None = None     # multi-scale TTA, e.g. "0.75,1.0,1.25"
    dataset_size: int | None = None    # subset (e.g. the 100-image VOC config)

    # precision / parallelism
    bf16: bool = True                  # bf16 compute, float32 params
    steps_per_call: int = 1            # K train steps per call (1 = off)
    grad_accum: int = 1                # one update from K microbatches (1 = off)
    remat: bool = False                # recompute the generator trunks
    num_devices: int | None = None     # None = all visible
    spatial_shards: int = 1            # spatial (H) partitioning factor
    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None

    # io
    checkpoint_dir: str = "./checkpoints"
    results_dir: str = "./results"
    keep_best: bool = False
    validation_every: int = 1          # epochs
    log_every: int = 20                # steps
    save_every_steps: int = 0          # mid-epoch checkpoints (0 = off)

    # observability
    profile_dir: str | None = None
    debug_nans: bool = False

    seed: int = 0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def crop_hw(self) -> tuple[int, int]:
        return (self.crop_height, self.crop_width)


# The five benchmark configurations of BASELINE.json.
PRESETS: dict[str, Config] = {
    # 1. VOC2012 100-image subset, 128x128, supervised-only CE, ResNet-6, batch 2
    "voc_supervised_128": Config(
        gen_net="resnet_6blocks", dataset="voc2012", dataset_size=100,
        crop_height=128, crop_width=128, batch_size=2, epochs=100, decay_epoch=50,
    ),
    # 2. VOC2012 256x256 full semi-supervised CycleGAN, ResNet-9 + PatchGAN,
    #    1/8 labeled
    "voc_semisup_256": Config(
        gen_net="resnet_9blocks", dataset="voc2012",
        crop_height=256, crop_width=256, labeled_fraction=0.125,
    ),
    # 3. Cityscapes 512x256 semi-supervised with pool replay + LambdaLR decay
    "cityscapes_semisup_512x256": Config(
        gen_net="resnet_9blocks", dataset="cityscapes",
        crop_height=256, crop_width=512,
    ),
    # 4. ACDC cardiac MRI, 1-channel, 4-class
    "acdc_semisup": Config(
        gen_net="resnet_9blocks", dataset="acdc",
        crop_height=256, crop_width=256,
    ),
    # 5. VOC2012 data-parallel over 8 devices, global batch 64, bf16
    "voc_dp8_bf16": Config(
        gen_net="resnet_9blocks", dataset="voc2012",
        crop_height=256, crop_width=256, batch_size=64, bf16=True, num_devices=8,
    ),
}


def preset(name: str) -> Config:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r} (have {sorted(PRESETS)})")
    return PRESETS[name]
