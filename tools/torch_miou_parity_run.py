#!/usr/bin/env python3
"""mIoU parity of cyclegan_tpu_torch against the JAX package (BASELINE.md's
measurement protocol, step 2, with the port in place of the torch oracle).

Trains the same supervised segmenter (``resnet_6blocks``, CE) in the JAX
package's ``SupervisedTrainer`` and in the port's, from identical weights
(the JAX init carried into the port by ``weights.load_flax_module``) on
identical fixed-seed batches of the synthetic corpus, then scores both on
the same validation set. Both compute in bf16 unless ``--no_bf16``.

Prints one JSON line: ``jax_miou``, ``port_miou``, ``delta`` (JAX minus
port), ``delta_pt`` (in mIoU points), the pixel accuracies,
``within_gate`` (``|delta_pt| <= 0.5``, the protocol's gate),
``argmax_agreement`` (the share of validation pixels where the two nets'
class maps agree) and ``background_only_miou`` (the score of class 0
everywhere: at the protocol's 300 steps both nets score about this, so
the gate shows no more than that both stay at that level).

    python3 tools/torch_miou_parity_run.py [--steps 300] [--size 64] [--no_bf16]

Both sides run on the CPU (the port's kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from cyclegan_tpu.data.datasets import make_dataset  # noqa: E402
from cyclegan_tpu.data.loader import Loader  # noqa: E402
from cyclegan_tpu.train import metrics as jmetrics  # noqa: E402
from cyclegan_tpu.train.supervised import SupervisedTrainer as JaxTrainer  # noqa: E402
from cyclegan_tpu.utils import config as jconfig  # noqa: E402
from cyclegan_tpu.utils.cpuflags import apply_tool_platform  # noqa: E402
from cyclegan_tpu_torch import weights  # noqa: E402
from cyclegan_tpu_torch.train.supervised import SupervisedTrainer  # noqa: E402
from cyclegan_tpu_torch.utils import config as tconfig  # noqa: E402

GATE_PT = 0.5


def run(steps: int = 300, size: int = 64, ngf: int = 8, n_blocks: int = 6, batch: int = 4,
        classes: int = 21, bf16: bool = True, val_images: int = 24) -> dict:
    loader = Loader(make_dataset("synthetic", split="train", size=64), batch_size=batch,
                    crop_hw=(size, size), train=True, seed=0)
    batches, epoch = [], 0
    while len(batches) < steps:
        batches.extend(list(loader.epoch(epoch))[:steps - len(batches)])
        epoch += 1
    val = list(Loader(make_dataset("synthetic", split="val", size=val_images),
                      batch_size=batch, crop_hw=(size, size), train=False,
                      drop_last=False).epoch(0))

    kw = dict(ngf=ngf, bf16=bf16, crop_height=size, crop_width=size, batch_size=batch,
              epochs=10_000, decay_epoch=5_000)
    jt = JaxTrainer(jconfig.Config(gen_net="resnet_6blocks", **kw), classes, 3,
                    steps_per_epoch=1)
    jt.model = jt.model.clone(n_blocks=n_blocks)
    js = jt.init_state(jax.random.PRNGKey(0))
    tt = SupervisedTrainer(tconfig.Config(gen_net=f"resnet_{n_blocks}blocks", **kw), classes,
                           3, steps_per_epoch=1, device="cpu")
    ts = tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_module(tt.model, js.params)

    t0 = time.perf_counter()
    step = jax.jit(jt.train_step, donate_argnums=0)
    for b in batches:
        js, jm = step(js, {"image": jnp.asarray(b["image"]), "label": jnp.asarray(b["label"])})
    jax_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for b in batches:
        ts, tm = tt.train_step(ts, {"image": torch.from_numpy(b["image"]),
                                    "label": torch.from_numpy(b["label"])})
    port_s = time.perf_counter() - t0

    def scores(preds: list) -> tuple[float, float]:
        hist = np.zeros((classes, classes), np.int64)
        for p, b in zip(preds, val):
            hist += np.asarray(jmetrics.confusion_matrix(
                jnp.asarray(p), jnp.asarray(b["label"]), classes))
        s = jmetrics.scores(jnp.asarray(hist))
        return float(s["miou"]), float(s["pixel_acc"])

    j_pred = jax.jit(lambda x: jnp.argmax(jt.logits(js.params, x), -1))
    j_maps = [np.asarray(j_pred(jnp.asarray(b["image"]))) for b in val]
    t_maps = [tt.predict(torch.from_numpy(b["image"])).numpy() for b in val]
    j_miou, j_pa = scores(j_maps)
    t_miou, t_pa = scores(t_maps)
    # The score of class 0 everywhere: a net at about this mIoU predicts
    # background only, and a delta between two such nets says little.
    bg_miou, _ = scores([np.zeros(m.shape, m.dtype) for m in j_maps])
    delta = j_miou - t_miou
    return {"jax_miou": j_miou, "port_miou": t_miou, "delta": delta, "delta_pt": 100 * delta,
            "gate_pt": GATE_PT, "within_gate": abs(100 * delta) <= GATE_PT,
            "background_only_miou": bg_miou,
            "argmax_agreement": float(np.mean(np.concatenate(
                [(j == t).ravel() for j, t in zip(j_maps, t_maps)]))),
            "jax_pixel_acc": j_pa, "port_pixel_acc": t_pa,
            "jax_final_ce": float(jm["ce_loss"]), "port_final_ce": float(tm["ce_loss"]),
            "steps": steps, "size": size, "ngf": ngf, "n_blocks": n_blocks, "batch": batch,
            "classes": classes, "bf16": bf16, "jax_train_s": jax_s, "port_train_s": port_s,
            "torch_threads": torch.get_num_threads(), "platform": "cpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--ngf", type=int, default=8)
    ap.add_argument("--n_blocks", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--classes", type=int, default=21)
    ap.add_argument("--no_bf16", dest="bf16", action="store_false",
                    help="compute in float32 on both sides")
    args = ap.parse_args(argv)
    apply_tool_platform("cpu")
    print(json.dumps(run(args.steps, args.size, args.ngf, args.n_blocks, args.batch,
                         args.classes, args.bf16)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
