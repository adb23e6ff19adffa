"""Worker-process loader on ``torch.utils.data.DataLoader``.

Counterpart of ``cyclegan_tpu/data/grain_loader.py`` (``--loader grain``),
under the same name so the flag maps to it; it imports no ``grain``. The
sampling is :class:`~cyclegan_tpu_torch.data.loader.Loader`'s: the epoch's
order and each sample's global position are computed here, each worker
augments a sample with ``np.random.default_rng((seed, epoch, position))``,
and the DataLoader hands the samples back in order (``batch_size=None``:
the batches are stacked here, never inside a worker, so the stream does
not depend on the worker count). It yields the same batches as ``Loader``.
Workers start with the ``spawn`` method, once an epoch.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch.utils.data

from cyclegan_tpu_torch.data.datasets import SegmentationDataset
from cyclegan_tpu_torch.data.loader import EVAL_MODES, check_process_shard, epoch_jobs, pad_batch
from cyclegan_tpu_torch.data.transforms import eval_transform, train_transform


class _EpochSamples(torch.utils.data.Dataset):
    """One epoch's transformed samples, in the epoch's order."""

    def __init__(self, ds: SegmentationDataset, order: np.ndarray, positions: np.ndarray, *,
                 crop_hw, train: bool, resize_hw, seed: int, epoch: int, eval_mode: str):
        self.ds, self.order, self.positions = ds, order, positions
        self.crop_hw, self.train, self.resize_hw = crop_hw, train, resize_hw
        self.seed, self.epoch, self.eval_mode = seed, epoch, eval_mode

    def __len__(self) -> int:
        return len(self.order)

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray | None]:
        img, lab = self.ds.get(int(self.order[i]))
        if self.train:
            rng = np.random.default_rng((self.seed, self.epoch, int(self.positions[i])))
            img, lab = train_transform(img, lab, crop_hw=self.crop_hw, rng=rng,
                                       resize_hw=self.resize_hw)
        else:
            img, lab = eval_transform(img, lab, crop_hw=self.crop_hw, mode=self.eval_mode)
        return img, (lab.astype(np.int32) if lab is not None else None)


def _as_is(sample):
    """Keep the numpy arrays (the default would turn them into tensors)."""
    return sample


class GrainLoader:
    """Epoch-aware batch iterator with ``num_workers`` worker processes,
    with :class:`Loader`'s interface and stream."""

    def __init__(self, ds: SegmentationDataset, *, batch_size: int,
                 crop_hw: tuple[int, int], train: bool = True, seed: int = 0,
                 resize_hw: tuple[int, int] | None = None, drop_last: bool = True,
                 num_workers: int = 0, process_shard: tuple[int, int] | None = None,
                 eval_mode: str = "resize"):
        if eval_mode not in EVAL_MODES:
            raise ValueError(f"unknown eval_mode {eval_mode!r} (resize|center_crop)")
        check_process_shard(process_shard)
        self.ds = ds
        self.batch_size = batch_size
        self.crop_hw = crop_hw
        self.train = train
        self.seed = seed
        self.resize_hw = resize_hw
        self.eval_mode = eval_mode
        self.drop_last = drop_last
        self.num_workers = num_workers
        self._epoch = 0

    def steps_per_epoch(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int | None = None) -> Iterator[dict]:
        """Iterate one epoch, deterministic given (seed, epoch) and equal to
        :meth:`Loader.epoch`. Close the generator (or run it to its end) to
        stop the workers."""
        e = self._epoch if epoch is None else epoch
        self._epoch = e + 1
        jobs = epoch_jobs(len(self.ds), self.batch_size, train=self.train, seed=self.seed,
                          epoch=e, drop_last=self.drop_last)
        if not jobs:
            return
        samples = _EpochSamples(
            self.ds, np.concatenate([j[0] for j in jobs]), np.concatenate([j[1] for j in jobs]),
            crop_hw=self.crop_hw, train=self.train, resize_hw=self.resize_hw, seed=self.seed,
            epoch=e, eval_mode=self.eval_mode)
        loader = torch.utils.data.DataLoader(
            samples, batch_size=None, shuffle=False, num_workers=self.num_workers,
            collate_fn=_as_is,
            multiprocessing_context="spawn" if self.num_workers else None)
        it = iter(loader)
        try:
            for idxs, _ in jobs:
                recs = [next(it) for _ in idxs]
                batch = {"image": np.stack([img for img, _ in recs])}
                if all(lab is not None for _, lab in recs):
                    batch["label"] = np.stack([lab for _, lab in recs])
                yield pad_batch(batch, self.batch_size)
        finally:
            # Dropping the iterator shuts its worker processes down now.
            del it
