"""Summarise a port training run for the soak protocol: sustained steps/s,
the stall inventory, loss health, and the checkpoints it left.

The counterpart of ``tools/soak_summary.py`` for ``cyclegan_tpu_torch``
(Python alone: it runs where the port runs). The JSONL summary is that
tool's own, on the ``train_metrics.jsonl`` the port's runner writes; that
tool loads nothing of JAX. The checkpoint inventory is the port's
(``train/checkpoint.py``) in place of that tool's Orbax step directories:
``<n>.pt`` + ``<n>.json`` pairs under the checkpoint directory (epoch
checkpoints, ``n`` the epoch) and under its ``mid/`` (mid-epoch
checkpoints, ``n`` the step), each with the optimizer step its ``.json``
records, and any file whose pair is missing.

Run: python tools/torch_soak_summary.py RESULTS_DIR [CKPT_DIR]
"""

from __future__ import annotations

import json
import os
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools.soak_summary import summarize as summarize_metrics  # noqa: E402

_CKPT_FILE = re.compile(r"^(\d+)\.(pt|json)$")


def checkpoint_inventory(ckpt_dir: str) -> dict:
    """The epoch and mid-epoch checkpoints under ``ckpt_dir``: for each kind
    the numbers of the whole ``.pt`` / ``.json`` pairs, the optimizer step
    of each (by number), and the files without their pair."""
    out, unpaired = {}, []
    for kind, sub in (("epoch", ckpt_dir), ("mid", os.path.join(ckpt_dir, "mid"))):
        found: dict[int, dict] = {}
        for name in os.listdir(sub) if os.path.isdir(sub) else ():
            m = _CKPT_FILE.match(name)
            if m:
                found.setdefault(int(m.group(1)), {})[m.group(2)] = os.path.join(sub, name)
        pairs = sorted(n for n, files in found.items() if len(files) == 2)
        steps = {}
        for n in pairs:
            with open(found[n]["json"]) as f:
                steps[n] = json.load(f).get("step")
        out[f"{kind}_ckpts"] = pairs
        out[f"{kind}_ckpt_steps"] = steps
        unpaired += sorted(os.path.relpath(p, ckpt_dir) for files in found.values()
                           if len(files) == 1 for p in files.values())
    out["unpaired_ckpt_files"] = unpaired
    return out


def summarize(results_dir: str, ckpt_dir: str | None = None,
              stall_threshold_s: float = 10.0) -> dict:
    """The JSONL summary, and the checkpoint inventory when ``ckpt_dir`` is
    a directory."""
    out = summarize_metrics(results_dir, None, stall_threshold_s)
    if ckpt_dir and os.path.isdir(ckpt_dir):
        out.update(checkpoint_inventory(ckpt_dir))
    return out


if __name__ == "__main__":
    print(json.dumps(summarize(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else None)))
