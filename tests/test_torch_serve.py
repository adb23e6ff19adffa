"""The port's serving path against the JAX package, on the CPU.

A Flax G_i2l (ngf 8, 2 trunk blocks, 5 classes, 32x32) is carried into the
port with ``weights.load_flax_generator`` and exported as the port's
artifact. Served predictions must equal ``argmax(G.apply(...))`` wherever
JAX's top-2 logit gap is above 1e-4; ``scores.json`` must match JAX
``metrics.scores`` to 1e-6; a uint8-input artifact, a logits-head artifact
and the HTTP endpoint must give the same class maps.
"""

import io
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cyclegan_tpu.data.transforms import eval_transform as jax_eval_transform
from cyclegan_tpu.models.generators import ResnetGenerator as JaxResnetGenerator
from cyclegan_tpu.serve import _load_mask as jax_load_mask
from cyclegan_tpu.train import metrics as jax_metrics
from cyclegan_tpu_torch import export, main as cli, serve, weights
from cyclegan_tpu_torch.http_serve import make_server
from cyclegan_tpu_torch.models.generators import ResnetGenerator
from cyclegan_tpu_torch.train import metrics
from cyclegan_tpu_torch.utils.pipeline import InferencePipeline

N_CLASSES, NGF, N_BLOCKS, SIZE = 5, 8, 2, 32
STEMS = ("a", "b", "c")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    jg = JaxResnetGenerator(output_nc=N_CLASSES, ngf=NGF, n_blocks=N_BLOCKS, head="none")
    params = jax.device_get(jg.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, SIZE, SIZE, 3))))["params"]
    tg = ResnetGenerator(3, N_CLASSES, NGF, N_BLOCKS, head="none")
    weights.load_flax_generator(tg, params)

    rng = np.random.default_rng(0)
    imgs, gt = root / "imgs", root / "gt"
    imgs.mkdir()
    gt.mkdir()
    for s in STEMS:
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(imgs / f"{s}.png")
        mask = rng.integers(0, N_CLASSES, (40, 48)).astype(np.uint8)
        mask[:3] = 255  # void rows are ignored
        Image.fromarray(mask).save(gt / f"{s}.png")

    def art(name, **kw):
        opts = dict(gen_net="resnet_2blocks", ngf=NGF, num_classes=N_CLASSES,
                    in_channels=3, crop_hw=(SIZE, SIZE), dtype="float32",
                    dataset="synthetic")
        opts.update(kw)
        return export.export_generator(tg, str(root / name), **opts)

    out = root / "out"
    summary = serve.run_serve(art("f32"), str(imgs), str(out), batch_size=2,
                              gt_dir=str(gt), device="cpu")
    return dict(root=root, jg=jg, params=params, imgs=imgs, gt=gt, art=art, out=out,
                summary=summary)


def _pred(out_dir, stem):
    return np.asarray(Image.open(os.path.join(out_dir, f"{stem}_pred.png")))


def test_run_serve_matches_jax_argmax(setup):
    for s in STEMS:
        raw = np.asarray(Image.open(setup["imgs"] / f"{s}.png").convert("RGB"))
        x, _ = jax_eval_transform(raw, None, crop_hw=(SIZE, SIZE))
        logits = np.asarray(setup["jg"].apply({"params": setup["params"]},
                                              jnp.asarray(x[None])))[0]
        top2 = np.sort(logits, axis=-1)[..., -2:]
        decisive = (top2[..., 1] - top2[..., 0]) > 1e-4
        assert decisive.mean() > 0.9
        got = _pred(setup["out"], s)
        assert got.shape == (SIZE, SIZE)
        np.testing.assert_array_equal(got[decisive], logits.argmax(-1)[decisive])


def test_scores_match_jax_metrics(setup):
    hist = None
    for s in STEMS:
        lab = jax_load_mask(str(setup["gt"] / f"{s}.png"), (SIZE, SIZE), N_CLASSES, "resize")
        h = np.asarray(jax_metrics.confusion_matrix(jnp.asarray(_pred(setup["out"], s)),
                                                    jnp.asarray(lab), N_CLASSES))
        hist = h if hist is None else hist + h
    ref = jax_metrics.scores(jnp.asarray(hist))
    with open(setup["out"] / "scores.json") as f:
        got = json.load(f)
    assert got["scored"] == len(STEMS) and got["images"] == len(STEMS)
    for k in ("pixel_acc", "mean_acc", "miou", "fwiou"):
        assert abs(got[k] - float(ref[k])) < 1e-6, k
    np.testing.assert_allclose([got["per_class_iou"][f"class_{i}"] for i in range(N_CLASSES)],
                               np.asarray(ref["per_class_iou"]), atol=1e-6)


def test_confusion_matrix_matches_jax():
    rng = np.random.default_rng(3)
    pred = rng.integers(0, 21, (2, 16, 16)).astype(np.uint8)
    lab = rng.integers(0, 21, (2, 16, 16)).astype(np.int32)
    lab[0, :2] = 255
    got = metrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(lab), 21)
    ref = jax_metrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(lab), 21)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _png_bytes(out_dir):
    return {s: (out_dir / f"{s}_pred.png").read_bytes() for s in STEMS}


def test_uint8_input_artifact_is_byte_identical(setup):
    out = setup["root"] / "out_u8"
    serve.run_serve(setup["art"]("u8", input_dtype="uint8"), str(setup["imgs"]), str(out),
                    device="cpu")
    assert _png_bytes(out) == _png_bytes(setup["out"])


def test_logits_head_serves_the_same_maps(setup):
    art = setup["art"]("logits", head="logits")
    out = setup["root"] / "out_logits"
    serve.run_serve(art, str(setup["imgs"]), str(out), device="cpu")
    assert _png_bytes(out) == _png_bytes(setup["out"])
    fn, cfg, manifest = export.load_head(art, "cpu")
    assert cfg["head"] == manifest["head"] == "logits"
    assert fn(torch.zeros((1, SIZE, SIZE, 3))).shape == (1, SIZE, SIZE, N_CLASSES)


def test_manifest_keys(setup):
    with open(setup["root"] / "f32.json") as f:
        manifest = json.load(f)
    assert {"head", "dataset", "gen_net", "num_classes", "class_names", "trained_steps",
            "input_dtype"} <= set(manifest)
    assert manifest["class_names"] == [f"class_{i}" for i in range(N_CLASSES)]


def test_unported_serving_options_raise(setup):
    art = str(setup["root"] / "f32.pt")
    for opts in ({"flip": True}, {"scales": (1.0, 1.5)}, {"canvas_hw": (64, 64)},
                 {"data_parallel": True}):
        with pytest.raises(NotImplementedError):
            serve.build_predictor(art, device="cpu", **opts)


def test_http_endpoint_matches_run_serve(setup):
    server = make_server(str(setup["root"] / "f32.pt"), port=0, device="cpu", max_batch=4)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        with urllib.request.urlopen(base + "/info", timeout=30) as r:
            info = json.load(r)
        assert info["num_classes"] == N_CLASSES and info["device"] == "cpu"
        body = (setup["imgs"] / "a.png").read_bytes()
        answers = {}
        for fmt in ("png", "mask", "json"):
            req = urllib.request.Request(f"{base}/predict?format={fmt}", data=body)
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200
                answers[fmt] = r.read()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    ref = _pred(setup["out"], "a")
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(answers["mask"]))), ref)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(answers["png"]))), ref)
    idx, cnt = np.unique(ref, return_counts=True)
    assert json.loads(answers["json"])["class_pixels"] == {
        str(int(i)): int(n) for i, n in zip(idx, cnt)}


def test_cli_export_from_npz_then_serve(setup):
    root = setup["root"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(setup["params"])}
    np.savez(root / "g.npz", **flat)
    cli.main(["--export", str(root / "cli"), "--weights_npz", str(root / "g.npz"),
              "--gen_net", "resnet_2blocks", "--ngf", str(NGF), "--num_classes",
              str(N_CLASSES), "--crop_height", str(SIZE), "--crop_width", str(SIZE),
              "--no_bf16", "--dataset", "synthetic"])
    cli.main(["--serve", str(root / "cli.pt"), "--serve_input", str(setup["imgs"]),
              "--serve_output", str(root / "out_cli"), "--device", "cpu"])
    assert _png_bytes(root / "out_cli") == _png_bytes(setup["out"])


def test_bf16_artifact_on_cpu_mostly_agrees(setup):
    """bf16 compute runs the same path (the kernels' plain versions in bf16)
    and differs from float32 only at near-ties."""
    out = setup["root"] / "out_bf16"
    serve.run_serve(setup["art"]("bf16", dtype="bfloat16"), str(setup["imgs"]), str(out),
                    device="cpu")
    agree = np.mean([np.mean(_pred(out, s) == _pred(setup["out"], s)) for s in STEMS])
    assert agree > 0.9


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_inference_pipeline_keeps_order(depth):
    seen = []
    pipe = InferencePipeline(lambda payload, arr: seen.append((payload, int(arr[0]))), depth)
    for i in range(5):
        pipe.put(i, torch.tensor([10 * i]))
        assert len(pipe._pending) <= depth
    pipe.flush()
    assert seen == [(i, 10 * i) for i in range(5)]
