#!/usr/bin/env python3
"""Long-horizon semi-supervised CycleGAN trajectory of cyclegan_tpu_torch
against the JAX package.

The port's counterpart of ``tools/cyclegan_parity_run.py``, with the port
in place of the torch oracle: N alternating G/D steps of the JAX
``CycleGANTrainer`` and of the port's, from identical weights (the JAX init
carried into the port by ``weights.load_flax_cyclegan``) on one fixed batch
(``tests/parity_utils.py::make_fixed_batch``), the replay pools bypassed
(pool 0) so that both trajectories are free of random draws. Reports the
per-step G-loss gap relative to the JAX value (its mean is held to the 1%
bar of ``tests/test_train_parity.py``), the D-loss gap, and both trained
segmenters' mIoU on the synthetic validation set.

Legs beyond the flagship ResNet + PatchGAN + instance norm:
  --channels 1 --classes 4          the ACDC grayscale family
  --gen_net unet --dis_net pixel    the U-Net + PixelGAN pairing
  --norm batch                      batch norm's running averages, threaded

Prints one JSON line.

    python3 tools/torch_cyclegan_parity_run.py [--steps 50]

Both sides run on the CPU (the port's kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from parity_utils import make_fixed_batch  # noqa: E402

from cyclegan_tpu.data.datasets import make_dataset  # noqa: E402
from cyclegan_tpu.data.loader import Loader  # noqa: E402
from cyclegan_tpu.train import metrics as jmetrics  # noqa: E402
from cyclegan_tpu.train.cyclegan import CycleGANTrainer as JaxTrainer  # noqa: E402
from cyclegan_tpu.utils import config as jconfig  # noqa: E402
from cyclegan_tpu.utils.cpuflags import apply_tool_platform  # noqa: E402
from cyclegan_tpu_torch import weights  # noqa: E402
from cyclegan_tpu_torch.models.generators import UnetGenerator  # noqa: E402
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer  # noqa: E402
from cyclegan_tpu_torch.utils import config as tconfig  # noqa: E402

GATE = 0.01  # mean relative G-loss gap


def make_pair(*, classes: int, size: int, ngf: int, n_blocks: int, channels: int,
              gen_net: str, dis_net: str, norm: str, bf16: bool):
    """The JAX trainer and state and the port's, from the same weights."""
    downs = int(math.log2(size))
    kw = dict(dis_net="n_layers" if dis_net == "patch" else "pixel", norm=norm, ngf=ngf,
              ndf=ngf, bf16=bf16, crop_height=size, crop_width=size, batch_size=1,
              pool_size=0, epochs=10_000, decay_epoch=5_000)
    jgen = "unet_128" if gen_net == "unet" else "resnet_6blocks"
    jt = JaxTrainer(jconfig.Config(gen_net=jgen, **kw), classes, channels, steps_per_epoch=1)
    clone = dict(num_downs=downs) if gen_net == "unet" else dict(n_blocks=n_blocks)
    jt.G_i2l = jt.G_i2l.clone(**clone)
    jt.G_l2i = jt.G_l2i.clone(**clone)
    js = jt.init_state(jax.random.PRNGKey(0))
    tgen = "unet_128" if gen_net == "unet" else f"resnet_{n_blocks}blocks"
    tt = CycleGANTrainer(tconfig.Config(gen_net=tgen, **kw), classes, channels,
                         steps_per_epoch=1, device="cpu")
    if gen_net == "unet":
        d = tt.dtype
        tt.G_i2l = UnetGenerator(channels, classes, downs, ngf, norm=norm, head="none",
                                 dtype=d).to(memory_format=torch.channels_last).train()
        tt.G_l2i = UnetGenerator(classes, channels, downs, ngf, norm=norm, head="tanh",
                                 dtype=d).to(memory_format=torch.channels_last).train()
    ts = tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_cyclegan(tt, js)
    return jt, js, tt, ts


def run(steps: int = 50, size: int = 32, classes: int = 5, ngf: int = 8, n_blocks: int = 2,
        channels: int = 3, gen_net: str = "resnet", dis_net: str = "patch",
        norm: str = "instance", bf16: bool = False, val_images: int = 16) -> dict:
    jt, js, tt, ts = make_pair(classes=classes, size=size, ngf=ngf, n_blocks=n_blocks,
                               channels=channels, gen_net=gen_net, dis_net=dis_net, norm=norm,
                               bf16=bf16)
    _, jb = make_fixed_batch(classes, size, batch=1, channels=channels)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    step = jax.jit(jt.train_step, donate_argnums=0)
    g, d = {"jax": [], "port": []}, {"jax": [], "port": []}
    t0 = time.perf_counter()
    for _ in range(steps):
        js, jm = step(js, jb)
        ts, tm = tt.train_step(ts, tb)
        for side, m in (("jax", jm), ("port", tm)):
            g[side].append(float(m["g_total"]))
            d[side].append(float(m["d_total"]))
    seconds = time.perf_counter() - t0
    gj, gp = np.array(g["jax"]), np.array(g["port"])
    rel = np.abs(gp - gj) / np.maximum(np.abs(gj), 1e-6)
    dgap = np.abs(np.array(d["port"]) - np.array(d["jax"]))

    # The trained segmenters on the synthetic validation set (labels clamped
    # to this run's classes, images cut to its channels).
    val = Loader(make_dataset("synthetic", split="val", size=val_images), batch_size=2,
                 crop_hw=(size, size), train=False, drop_last=False)
    hist = {"jax": np.zeros((classes, classes), np.int64),
            "port": np.zeros((classes, classes), np.int64)}
    agree = []
    j_pred = jax.jit(lambda p, x: jnp.argmax(jt.G_i2l.apply(p, x), -1))
    for vb in val.epoch(0):
        lab = np.minimum(vb["label"], classes - 1)
        img = vb["image"][..., :channels]
        pj = np.asarray(j_pred(js.g_i2l, jnp.asarray(img)))
        pt = tt.predict(torch.from_numpy(np.ascontiguousarray(img))).numpy()
        agree.append(np.mean(pj == pt))
        for side, p in (("jax", pj), ("port", pt)):
            hist[side] += np.asarray(jmetrics.confusion_matrix(
                jnp.asarray(p), jnp.asarray(lab), classes))
    miou = {side: float(jmetrics.scores(jnp.asarray(h))["miou"]) for side, h in hist.items()}
    return {"steps": steps, "pool": 0, "gen_net": gen_net, "dis_net": dis_net, "norm": norm,
            "channels": channels, "classes": classes, "size": size, "bf16": bf16,
            "final_jax_g": float(gj[-1]), "final_port_g": float(gp[-1]),
            "mean_rel_divergence": float(rel.mean()), "max_rel_divergence": float(rel.max()),
            "gate": GATE, "within_gate": bool(rel.mean() < GATE),
            "d_mean_abs_divergence": float(dgap.mean()),
            "d_max_abs_divergence": float(dgap.max()),
            "jax_miou": miou["jax"], "port_miou": miou["port"],
            "miou_delta": miou["jax"] - miou["port"],
            "val_argmax_agreement": float(np.mean(agree)), "seconds": seconds,
            "platform": "cpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--classes", type=int, default=5)
    ap.add_argument("--ngf", type=int, default=8)
    ap.add_argument("--n_blocks", type=int, default=2)
    ap.add_argument("--channels", type=int, default=3,
                    help="image channels (1 = the ACDC grayscale family)")
    ap.add_argument("--gen_net", choices=["resnet", "unet"], default="resnet")
    ap.add_argument("--dis_net", choices=["patch", "pixel"], default="patch")
    ap.add_argument("--norm", choices=["instance", "batch"], default="instance")
    ap.add_argument("--bf16", action="store_true", help="compute in bf16 on both sides")
    args = ap.parse_args(argv)
    apply_tool_platform("cpu")
    print(json.dumps(run(args.steps, args.size, args.classes, args.ngf, args.n_blocks,
                         args.channels, args.gen_net, args.dis_net, args.norm, args.bf16)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
