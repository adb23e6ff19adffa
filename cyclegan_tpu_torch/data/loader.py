"""Batch loader with a background prefetch thread.

Counterpart of ``cyclegan_tpu/data/loader.py``. A thread builds fixed-shape
numpy batches while the train loop runs the previous step on the device.
The epoch's order is ``np.random.default_rng((seed, epoch))`` and each
sample's augment draws come from ``np.random.default_rng((seed, epoch,
position))``, so the stream is bit-identical to the JAX package's loader
for the same seed, and a resumed epoch replays its suffix exactly.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from cyclegan_tpu_torch.data import native
from cyclegan_tpu_torch.data.datasets import SegmentationDataset
from cyclegan_tpu_torch.data.transforms import (draw_train_params, eval_transform,
                                                train_transform)

EVAL_MODES = ("resize", "center_crop")


def check_process_shard(process_shard: tuple[int, int] | None) -> None:
    """The port runs one process: any shard other than (0, 1) raises."""
    if process_shard not in (None, (0, 1)):
        raise NotImplementedError(
            f"process_shard {process_shard}: multi-process loading arrives with the "
            f"parallel slice of the port (ROADMAP Queue 1 item 11)")


def empty_batch(crop_hw: tuple[int, int], in_channels: int) -> dict:
    """A batch of no rows (shared by Loader and GrainLoader)."""
    ch, cw = crop_hw
    return {"image": np.zeros((0, ch, cw, in_channels), np.float32),
            "label": np.zeros((0, ch, cw), np.int32)}


def pad_batch(batch: dict, rows: int) -> dict:
    """Pad a short final eval batch to ``rows`` with ignore-label (255)
    rows, which the loss and the confusion matrix mask, so every batch has
    one shape. Shared by Loader and GrainLoader, whose streams are equal."""
    n = batch["image"].shape[0]
    if n == rows:
        return batch
    pad = rows - n
    batch["image"] = np.concatenate(
        [batch["image"], np.zeros((pad,) + batch["image"].shape[1:], batch["image"].dtype)])
    if "label" in batch:
        batch["label"] = np.concatenate(
            [batch["label"], np.full((pad,) + batch["label"].shape[1:], 255,
                                     batch["label"].dtype)])
    return batch


def epoch_jobs(n: int, batch_size: int, *, train: bool, seed: int, epoch: int,
               drop_last: bool) -> list[tuple[np.ndarray, np.ndarray]]:
    """(dataset indices, global positions) of each batch of one epoch."""
    idxs = np.random.default_rng((seed, epoch)).permutation(n) if train else np.arange(n)
    nb = n // batch_size if drop_last else -(-n // batch_size)
    return [(idxs[k * batch_size:(k + 1) * batch_size],
             np.arange(k * batch_size, min((k + 1) * batch_size, n))) for k in range(nb)]


class Loader:
    """Shuffling, epoch-aware batch iterator with a prefetch thread.

    Yields dict batches of fixed shapes: image (B, H, W, C) float32 in
    [-1, 1] and, when the dataset has labels, label (B, H, W) int32.
    """

    def __init__(self, ds: SegmentationDataset, *, batch_size: int,
                 crop_hw: tuple[int, int], train: bool = True, seed: int = 0,
                 resize_hw: tuple[int, int] | None = None, drop_last: bool = True,
                 prefetch: int = 4, process_shard: tuple[int, int] | None = None,
                 eval_mode: str = "resize"):
        if eval_mode not in EVAL_MODES:
            # Fail here: inside the prefetch thread it would deadlock the consumer.
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
        self.prefetch = prefetch
        self._epoch = 0

    def steps_per_epoch(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _sample_rng(self, epoch: int, position: int) -> np.random.Generator:
        """One sample's augment RNG, keyed by its position in the epoch."""
        return np.random.default_rng((self.seed, epoch, position))

    def _make_batch(self, idxs: np.ndarray, positions: np.ndarray, epoch: int) -> dict:
        if self.train and native.available():
            return self._make_batch_native(idxs, positions, epoch)
        imgs, labs = [], []
        for i, pos in zip(idxs, positions):
            img, lab = self.ds.get(int(i))
            if self.train:
                img, lab = train_transform(img, lab, crop_hw=self.crop_hw,
                                           rng=self._sample_rng(epoch, int(pos)),
                                           resize_hw=self.resize_hw)
            else:
                img, lab = eval_transform(img, lab, crop_hw=self.crop_hw, mode=self.eval_mode)
            imgs.append(img)
            if lab is not None:
                labs.append(lab.astype(np.int32))
        batch = {"image": np.stack(imgs)} if imgs else empty_batch(self.crop_hw,
                                                                   self.ds.in_channels)
        if labs:
            batch["label"] = np.stack(labs)
        return pad_batch(batch, self.batch_size)

    def _make_batch_native(self, idxs: np.ndarray, positions: np.ndarray, epoch: int) -> dict:
        """The native crop + flip + normalize: the same parameter draws as
        the numpy path, bit-identical batches."""
        imgs, labs, tops, lefts, flips = [], [], [], [], []
        for i, pos in zip(idxs, positions):
            img, lab = self.ds.get(int(i))
            img, lab, top, left, flip = draw_train_params(
                img, lab, crop_hw=self.crop_hw, rng=self._sample_rng(epoch, int(pos)),
                resize_hw=self.resize_hw)
            imgs.append(img)
            labs.append(lab)
            tops.append(top)
            lefts.append(left)
            flips.append(flip)
        tops, lefts = np.asarray(tops, np.int32), np.asarray(lefts, np.int32)
        flips = np.asarray(flips, np.uint8)
        batch = {"image": native.crop_flip_normalize_batch(imgs, tops, lefts, flips,
                                                           self.crop_hw)}
        if all(lb is not None for lb in labs):
            batch["label"] = native.crop_flip_label_batch(labs, tops, lefts, flips,
                                                          self.crop_hw)
        return batch

    def epoch(self, epoch: int | None = None) -> Iterator[dict]:
        """Iterate one epoch, deterministic given (seed, epoch). Close the
        generator (or run it to its end) to stop the prefetch thread."""
        e = self._epoch if epoch is None else epoch
        self._epoch = e + 1
        jobs = epoch_jobs(len(self.ds), self.batch_size, train=self.train, seed=self.seed,
                          epoch=e, drop_last=self.drop_last)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        error: list[BaseException] = []

        def worker():
            try:
                for b, pos in jobs:
                    if stop.is_set():
                        return
                    q.put(self._make_batch(b, pos, e))
            except Exception as exc:  # handed to the consumer below
                error.append(exc)
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
            # Unblock a worker waiting in q.put() after an early exit so it
            # sees `stop` and ends.
            try:
                q.get_nowait()
            except queue.Empty:
                pass


def paired_iterator(labeled, unlabeled, epoch: int, *, mode: str = "zip"
                    ) -> Iterator[tuple[dict, dict]]:
    """Pair the labeled and unlabeled streams for one epoch.

    ``zip`` (the reference's pairing): the epoch ends with the shorter
    stream. ``cycle``: the unlabeled stream sets the epoch's length and the
    labeled stream cycles with fresh shuffles."""
    if mode == "zip":
        lab_it, unlab_it = labeled.epoch(epoch), unlabeled.epoch(epoch)
        try:
            yield from zip(lab_it, unlab_it)
        finally:
            # Close both now, so the longer stream's thread stops here.
            lab_it.close()
            unlab_it.close()
        return
    if mode != "cycle":
        raise ValueError(f"unknown pairing mode {mode!r} (expected zip|cycle)")
    lab_stream = _cycle(labeled, epoch)
    unlab_it = unlabeled.epoch(epoch)
    try:
        for unlab_batch in unlab_it:
            yield next(lab_stream), unlab_batch
    finally:
        unlab_it.close()
        lab_stream.close()


def paired_steps_per_epoch(labeled, unlabeled, mode: str = "zip") -> int:
    """Epoch length that :func:`paired_iterator` will produce."""
    if mode == "zip":
        return min(labeled.steps_per_epoch(), unlabeled.steps_per_epoch())
    return unlabeled.steps_per_epoch()


def _cycle(loader, epoch: int) -> Iterator[dict]:
    sub = 0
    while True:
        it = loader.epoch(epoch * 1000 + sub)
        try:
            yield from it
        finally:
            it.close()
        sub += 1
