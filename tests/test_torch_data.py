"""The port's data pipeline against ``cyclegan_tpu.data``, on the CPU.

Everything here is held bit-exact (numpy integer and float32 arithmetic in
the same order, the same RNG draws): the train transforms, the readers on
the synthetic data and on on-disk fixture trees (written by the JAX
package's own CLI fixture writers), the labeled/unlabeled split, the
``Loader``'s batches on the native and the numpy pixel paths (train, eval,
padding, center crop, resize), the paired iterators, the palette codecs and
one-hot; and the DataLoader-backed ``GrainLoader`` against ``Loader``.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from cyclegan_tpu.data import datasets as jds
from cyclegan_tpu.data import loader as jloader
from cyclegan_tpu.data import native as jnative
from cyclegan_tpu.data import palette as jpal
from cyclegan_tpu.data import transforms as jtf
from cyclegan_tpu_torch.data import datasets as tds
from cyclegan_tpu_torch.data import loader as tloader
from cyclegan_tpu_torch.data import native as tnative
from cyclegan_tpu_torch.data import palette as tpal
from cyclegan_tpu_torch.data import transforms as ttf
from cyclegan_tpu_torch.data.grain_loader import GrainLoader
from test_cli_fixture_drives import (_write_acdc_realistic, _write_cityscapes_realistic,
                                     _write_voc_realistic)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host,
    and torch's default (a thread per core in every worker) oversubscribes
    it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same_batches(a: list, b: list) -> None:
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _same_dataset(t, j) -> None:
    assert len(t) == len(j) and list(t.items) == list(j.items)
    assert (t.num_classes, t.in_channels) == (j.num_classes, j.in_channels)
    for i in range(len(j)):
        for a, b in zip(t.get(i), j.get(i)):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("resize_hw", [None, (50, 70)])
def test_train_transforms_match_jax(resize_hw):
    img, lab = tds._synthetic_sample(3, (40, 48), 21, 3)
    for seed in range(4):
        for crop in ((32, 32), (64, 40)):  # the second upscales first
            t = ttf.draw_train_params(img, lab, crop_hw=crop, resize_hw=resize_hw,
                                      rng=np.random.default_rng(seed))
            j = jtf.draw_train_params(img, lab, crop_hw=crop, resize_hw=resize_hw,
                                      rng=np.random.default_rng(seed))
            assert t[2:] == j[2:]
            for a, b in zip(ttf.train_transform(img, lab, crop_hw=crop, resize_hw=resize_hw,
                                                rng=np.random.default_rng(seed)),
                            jtf.train_transform(img, lab, crop_hw=crop, resize_hw=resize_hw,
                                                rng=np.random.default_rng(seed))):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(ttf.random_crop_pair(img, lab, (16, 24), np.random.default_rng(seed)),
                        jtf.random_crop_pair(img, lab, (16, 24), np.random.default_rng(seed))):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ttf.random_hflip_pair(img, lab, np.random.default_rng(seed)),
                        jtf.random_hflip_pair(img, lab, np.random.default_rng(seed))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["synthetic", "synthetic_gray"])
def test_synthetic_dataset_and_split_match_jax(name):
    for split, size in (("train", 12), ("val", None)):
        t = tds.make_dataset(name, split=split, size=size)
        j = jds.make_dataset(name, split=split, size=size)
        _same_dataset(t, j)
    t = tds.make_dataset(name, size=9)
    j = jds.make_dataset(name, size=9)
    for frac in (0.125, 0.5, 1.0):
        for a, b in zip(tds.split_labeled(t, frac, seed=3), jds.split_labeled(j, frac, seed=3)):
            _same_dataset(a, b)
    with pytest.raises(ValueError, match="unknown dataset"):
        tds.make_dataset("nope")


@pytest.mark.parametrize("name", ["voc2012", "cityscapes", "acdc"])
def test_readers_match_jax_on_fixture_trees(tmp_path, name):
    write = {"voc2012": _write_voc_realistic, "cityscapes": _write_cityscapes_realistic,
             "acdc": _write_acdc_realistic}[name]
    write(tmp_path / name)
    for split in ("train", "val"):
        _same_dataset(tds.make_dataset(name, str(tmp_path / name), split=split, size=4),
                      jds.make_dataset(name, str(tmp_path / name), split=split, size=4))
    with pytest.raises(FileNotFoundError):
        tds.make_dataset(name, str(tmp_path / "absent"))


def test_rgb_encoded_mask_decodes_to_class_ids(tmp_path):
    """A VOC mask saved as RGB goes through the colormap codec."""
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        (tmp_path / d).mkdir(parents=True)
    lab = np.zeros((16, 16), np.uint8)
    lab[:8], lab[8:, :8], lab[8:, 8:] = 1, 15, 255
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(tmp_path / "JPEGImages" / "x.jpg")
    Image.fromarray(tpal.decode_colormap(lab)).save(tmp_path / "SegmentationClass" / "x.png")
    (tmp_path / "ImageSets/Segmentation/train.txt").write_text("x\n")
    _, got = tds.make_dataset("voc2012", str(tmp_path)).get(0)
    np.testing.assert_array_equal(got, lab)


LOADER_CASES = {
    "train": dict(batch_size=3, crop_hw=(32, 32), train=True, seed=7),
    "train_resize": dict(batch_size=2, crop_hw=(24, 40), train=True, seed=1,
                         resize_hw=(48, 64)),
    "eval_pad": dict(batch_size=4, crop_hw=(32, 32), train=False, drop_last=False),
    "eval_center_crop": dict(batch_size=2, crop_hw=(24, 32), train=False, drop_last=False,
                             eval_mode="center_crop"),
}


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_bit_identical_to_jax(monkeypatch, case, use_native):
    if use_native:
        assert tnative.available() and jnative.available()
    else:
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    kw = LOADER_CASES[case]
    ds_t = tds.make_dataset("synthetic", split="train" if kw["train"] else "val", size=10)
    ds_j = jds.make_dataset("synthetic", split="train" if kw["train"] else "val", size=10)
    lt, lj = tloader.Loader(ds_t, **kw), jloader.Loader(ds_j, **kw)
    assert lt.steps_per_epoch() == lj.steps_per_epoch()
    for e in (0, 3):
        _same_batches(list(lt.epoch(e)), list(lj.epoch(e)))


def test_native_entry_points_match_numpy():
    r = np.random.default_rng(0)
    imgs = [r.integers(0, 255, (20 + i, 30, 3), dtype=np.uint8) for i in range(3)]
    labs = [r.integers(0, 21, (20 + i, 30), dtype=np.uint8) for i in range(3)]
    tops, lefts = np.array([0, 3, 5], np.int32), np.array([1, 0, 4], np.int32)
    flips = np.array([1, 0, 1], np.uint8)
    assert tnative.available()
    got = (tnative.crop_flip_normalize_batch(imgs, tops, lefts, flips, (16, 24)),
           tnative.crop_flip_label_batch(labs, tops, lefts, flips, (16, 24)),
           tnative.one_hot(labs[0].astype(np.int32), 21))
    ref = (jnative.crop_flip_normalize_batch(imgs, tops, lefts, flips, (16, 24)),
           jnative.crop_flip_label_batch(labs, tops, lefts, flips, (16, 24)),
           jpal.one_hot(labs[0].astype(np.int32), 21))
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["zip", "cycle"])
def test_paired_iterator_matches_jax(mode):
    kw = dict(batch_size=2, crop_hw=(16, 16), train=True)
    lab_t, unlab_t = tds.split_labeled(tds.make_dataset("synthetic", size=12), 0.25, seed=0)
    lab_j, unlab_j = jds.split_labeled(jds.make_dataset("synthetic", size=12), 0.25, seed=0)
    pt = (tloader.Loader(lab_t, seed=0, **kw), tloader.Loader(unlab_t, seed=1, **kw))
    pj = (jloader.Loader(lab_j, seed=0, **kw), jloader.Loader(unlab_j, seed=1, **kw))
    assert tloader.paired_steps_per_epoch(*pt, mode) == \
        jloader.paired_steps_per_epoch(*pj, mode) == (1 if mode == "zip" else 4)
    got = list(tloader.paired_iterator(*pt, 2, mode=mode))
    ref = list(jloader.paired_iterator(*pj, 2, mode=mode))
    _same_batches([a for a, _ in got], [a for a, _ in ref])
    _same_batches([b for _, b in got], [b for _, b in ref])
    with pytest.raises(ValueError, match="pairing mode"):
        list(tloader.paired_iterator(*pt, 0, mode="nope"))


def test_early_close_stops_the_prefetch_thread():
    import threading

    ds = tds.make_dataset("synthetic", size=40)
    before = set(threading.enumerate())
    it = tloader.Loader(ds, batch_size=1, crop_hw=(16, 16), prefetch=1).epoch(0)
    next(it)
    (worker,) = set(threading.enumerate()) - before
    it.close()
    worker.join(timeout=10)
    assert not worker.is_alive()


@pytest.mark.parametrize("case,workers", [("train", 0), ("eval_pad", 0), ("train", 2)])
def test_grain_loader_equals_loader(case, workers):
    kw = LOADER_CASES[case]
    ds = tds.make_dataset("synthetic", split="train" if kw["train"] else "val", size=9)
    ref = list(tloader.Loader(ds, **kw).epoch(1))
    gl = GrainLoader(ds, num_workers=workers, **kw)
    assert gl.steps_per_epoch() == len(ref)
    _same_batches(list(gl.epoch(1)), ref)


@pytest.mark.parametrize("make", [tloader.Loader, GrainLoader])
def test_loaders_refuse_other_process_shards_and_eval_modes(make):
    ds = tds.make_dataset("synthetic", size=4)
    make(ds, batch_size=2, crop_hw=(8, 8), process_shard=(0, 1))
    make(ds, batch_size=2, crop_hw=(8, 8), process_shard=(1, 2))  # tests/test_torch_parallel.py
    with pytest.raises(ValueError, match="not divisible"):
        make(ds, batch_size=3, crop_hw=(8, 8), process_shard=(1, 2))
    with pytest.raises(ValueError, match="rank outside"):
        make(ds, batch_size=2, crop_hw=(8, 8), process_shard=(2, 2))
    with pytest.raises(ValueError, match="eval_mode"):
        make(ds, batch_size=2, crop_hw=(8, 8), eval_mode="tile")


def test_palette_and_one_hot_match_jax(tmp_path):
    r = np.random.default_rng(4)
    labels = r.integers(0, 21, (2, 9, 11)).astype(np.int32)
    labels[0, :2] = 255
    np.testing.assert_array_equal(tpal.decode_colormap(labels[0]),
                                  jpal.decode_colormap(labels[0]))
    np.testing.assert_array_equal(tpal.one_hot(labels, 21), jpal.one_hot(labels, 21))
    np.testing.assert_array_equal(tpal.one_hot(labels[1], 21, ignore_index=None),
                                  jpal.one_hot(labels[1], 21, ignore_index=None))
    rgb = tpal.decode_colormap(labels[0])
    np.testing.assert_array_equal(tpal.encode_colormap(rgb, 21), jpal.encode_colormap(rgb, 21))
    ti, ji = tpal.palette_image(labels[0]), jpal.palette_image(labels[0])
    assert ti.mode == ji.mode == "P" and ti.getpalette() == ji.getpalette()
    np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
    tpal.save_prediction_png(labels[0], tmp_path / "t.png")
    jpal.save_prediction_png(labels[0], tmp_path / "j.png")
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
