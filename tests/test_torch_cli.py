"""The port's CLI (``python -m cyclegan_tpu_torch.main``) on the JAX
package's realistic fixture trees (``tests/test_cli_fixture_drives.py``),
on the CPU: train -> validation -> sample dumps -> checkpoint -> resume ->
``--testing`` (restore, palette PNGs, scores).

The JAX drive resumes after ``--max_steps 1`` cut an epoch and saved it as
complete; the port saves a cut epoch as a mid-epoch checkpoint instead, so
these drives use epochs of one step (VOC: 3 labeled images at batch 2).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from cyclegan_tpu_torch.main import main
from test_cli_fixture_drives import _write_cityscapes_realistic, _write_voc_realistic


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host,
    and torch's default (a thread per core in every worker) oversubscribes
    it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flags(tmp_path, crop_h, crop_w, device=("--device", "cpu")):
    return [*device, "--no_bf16", "--ngf", "4", "--ndf", "4", "--gen_net", "resnet_2blocks",
            "--crop_height", str(crop_h), "--crop_width", str(crop_w),
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--results_dir", str(tmp_path / "res"),
            "--log_every", "1", "--validation_every", "1"]


def _pred_pngs(tmp_path, n):
    preds = sorted((tmp_path / "res").glob("pred_*.png"))
    assert len(preds) == n  # one per val image; padding rows skipped
    with Image.open(preds[0]) as im:
        assert im.mode == "P"  # class indices, rendered with the VOC palette
        assert np.asarray(im.convert("RGB")).shape[-1] == 3


def test_voc_cli_train_resume_test(tmp_path, capsys):
    _write_voc_realistic(tmp_path / "voc")
    flags = _flags(tmp_path, 32, 32) + [
        "--dataset", "voc2012", "--data_root", str(tmp_path / "voc"), "--batch_size", "2",
        "--labeled_fraction", "0.5", "--pool_size", "2", "--epochs", "2", "--decay_epoch", "1"]
    main(["--training", "--max_steps", "1"] + flags)
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("*.pt")) == ["0.pt"]
    assert any("sample" in p.name for p in (tmp_path / "res").glob("*.png"))
    last_val = main(["--training", "--max_steps", "1"] + flags)
    out = capsys.readouterr().out
    assert "resumed from epoch 0" in out and "[epoch 1 step 2]" in out
    scores = main(["--testing"] + flags)
    out = capsys.readouterr().out
    assert "test scores" in out and "miou" in out
    # --testing restores epoch 1's weights and scores what its validation did.
    for key in ("miou", "pixel_acc"):
        assert scores[key] == pytest.approx(last_val[key], abs=1e-6)
    _pred_pngs(tmp_path, 2)


def test_cityscapes_cli_train_test(tmp_path, capsys):
    _write_cityscapes_realistic(tmp_path / "cs")
    flags = _flags(tmp_path, 32, 64, device=("--platform", "cpu")) + [
        "--dataset", "cityscapes", "--data_root", str(tmp_path / "cs"), "--batch_size", "2",
        "--labeled_fraction", "0.5", "--pool_size", "0", "--epochs", "1", "--decay_epoch", "1"]
    main(["--training"] + flags)
    assert any("sample" in p.name for p in (tmp_path / "res").glob("*.png"))
    main(["--testing"] + flags)
    assert "test scores" in capsys.readouterr().out
    _pred_pngs(tmp_path, 3)


def test_cli_refuses_what_is_not_ported_and_a_missing_card(tmp_path, monkeypatch):
    flags = _flags(tmp_path, 32, 32) + ["--dataset", "synthetic", "--dataset_size", "4"]
    for mode in ("--training", "--testing"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            main([mode, "--model", "supervised"] + flags)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        main(["--training", "--eval_flip", "true"] + flags)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        main(["--training", "--preset", "voc_dp8_bf16"] + flags)
    # No --device: the card, and without one the CLI refuses.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--training"] + _flags(tmp_path, 32, 32, device=()) +
             ["--dataset", "synthetic", "--dataset_size", "4"])
    with pytest.raises(SystemExit):
        main(flags)
