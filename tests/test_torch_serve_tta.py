"""The port's tiled, TTA and data-parallel serving against the JAX package,
on the CPU.

A Flax G_i2l (ngf 8, 2 trunk blocks, 5 classes, 32x32 window, float32) is
carried into the port and exported as a logits artifact; the same weights
go into a JAX ``.shlo`` logits artifact. Then:

- tiled serving on a 64x48 canvas writes the same class maps as the JAX
  ``run_serve`` wherever JAX's tiled top-2 logit gap is above 1e-4, and a
  canvas equal to the window writes the same PNG bytes as untiled serving;
- the served logits of flip, and of flip + scales 0.75/1.0/1.25 on the
  canvas, are within 1e-5 of the JAX composition
  ``scale_avg(flip_avg(tiled))`` (relative to the largest logit), and
  ``run_serve`` with them agrees with the JAX one on decisive pixels;
- ``data_parallel_predictor`` over two CPU replicas equals one, ragged
  batch included;
- every option the JAX ``build_predictor`` refuses, the port refuses too,
  both with a ValueError that says why;
- the HTTP endpoint reports its options under ``/info``'s ``tta`` with
  the JAX keys and answers a flip + canvas request as ``run_serve`` does;
- a ``unet_128`` and a ``norm=batch`` artifact serve the JAX module's
  eval-mode argmax on decisive pixels.
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

from cyclegan_tpu import eval_tile as jeval_tile
from cyclegan_tpu import export as jexport
from cyclegan_tpu import serve as jserve
from cyclegan_tpu import tta as jtta
from cyclegan_tpu.models.generators import ResnetGenerator as JaxResnetGenerator
from cyclegan_tpu.models.generators import UnetGenerator as JaxUnet
from cyclegan_tpu_torch import export, serve, weights
from cyclegan_tpu_torch.http_serve import make_server
from cyclegan_tpu_torch.models.generators import ResnetGenerator, define_Gen

N_CLASSES, NGF, N_BLOCKS, SIZE = 5, 8, 2, 32
CANVAS = (64, 48)
SCALES = (0.75, 1.0, 1.25)
STEMS = ("a", "b", "c")
TOL = 1e-5  # of the largest logit


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_images(d, shape, n=len(STEMS), seed=0):
    rng = np.random.default_rng(seed)
    d.mkdir()
    for s in STEMS[:n]:
        Image.fromarray(rng.integers(0, 256, shape + (3,), dtype=np.uint8)).save(d / f"{s}.png")
    return d


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_tta")
    jg = JaxResnetGenerator(output_nc=N_CLASSES, ngf=NGF, n_blocks=N_BLOCKS, head="none")
    variables = jax.device_get(jg.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    tg = ResnetGenerator(3, N_CLASSES, NGF, N_BLOCKS, head="none")
    weights.load_flax_module(tg, variables)
    opts = dict(gen_net=f"resnet_{N_BLOCKS}blocks", ngf=NGF, num_classes=N_CLASSES,
                in_channels=3, crop_hw=(SIZE, SIZE), dtype="float32", dataset="synthetic")
    art = {head: export.export_generator(tg, str(root / head), head=head, **opts)
           for head in ("segment", "logits")}
    art["uint8"] = export.export_generator(tg, str(root / "u8"), head="logits",
                                           input_dtype="uint8", **opts)

    def jart(name, fn, head, dtype=jnp.float32):
        exported = jexport.export_predictor(fn, variables, height=SIZE, width=SIZE,
                                            in_channels=3, platforms=("cpu",), dtype=dtype)
        path = str(root / f"{name}.shlo")
        jexport.save_artifact(path, exported, manifest={"head": head, "num_classes": N_CLASSES})
        return path

    jlogits = jart("jlogits", jg.apply, "logits")
    return dict(root=root, jg=jg, variables=variables, art=art, jlogits=jlogits, jart=jart,
                imgs=_write_images(root / "imgs", (40, 56)))


def _pngs(out_dir):
    return {s: np.asarray(Image.open(os.path.join(out_dir, f"{s}_pred.png"))) for s in STEMS}


def _canvas_batch(imgs, hw=CANVAS):
    return np.stack([jserve._load_image(str(imgs / f"{s}.png"), hw, 3, "resize")
                     for s in STEMS])


def _jax_logits(setup, x, *, flip=False, scales=None):
    jg, v = setup["jg"], setup["variables"]

    def fn(p, xx):
        return jeval_tile.tiled_logits(jg.apply, p, xx, (SIZE, SIZE))

    if flip:
        fn = jtta.flip_avg(fn)
    if scales:
        fn = jtta.scale_avg(fn, scales)
    return np.asarray(fn(v, jnp.asarray(x)))


def _decisive(logits, gap=1e-4):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > gap


def test_tiled_serving_matches_jax_run_serve(setup, tmp_path):
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    res = serve.run_serve(setup["art"]["logits"], str(setup["imgs"]), str(ours), batch_size=2,
                          canvas_hw=CANVAS, device="cpu")
    jserve.run_serve(setup["jlogits"], str(setup["imgs"]), str(ref), batch_size=2,
                     canvas_hw=CANVAS)
    assert res["images"] == len(STEMS)
    got, want = _pngs(ours), _pngs(ref)
    decisive = _decisive(_jax_logits(setup, _canvas_batch(setup["imgs"])))
    assert decisive.mean() > 0.9
    for i, s in enumerate(STEMS):
        assert got[s].shape == CANVAS
        np.testing.assert_array_equal(got[s][decisive[i]], want[s][decisive[i]])


def test_canvas_equal_to_window_is_untiled_serving(setup, tmp_path):
    art, imgs = setup["art"]["logits"], str(setup["imgs"])
    serve.run_serve(art, imgs, str(tmp_path / "plain"), device="cpu")
    serve.run_serve(art, imgs, str(tmp_path / "tiled"), canvas_hw=(SIZE, SIZE), device="cpu")
    for s in STEMS:
        assert ((tmp_path / "plain" / f"{s}_pred.png").read_bytes()
                == (tmp_path / "tiled" / f"{s}_pred.png").read_bytes())


@pytest.mark.parametrize("flip,scales,canvas", [(True, None, None), (True, None, CANVAS),
                                                (True, SCALES, CANVAS)])
def test_tta_logits_match_the_jax_composition(setup, flip, scales, canvas):
    hw = canvas or (SIZE, SIZE)
    x = _canvas_batch(setup["imgs"], hw)
    fn, cfg, _ = export.load_head(setup["art"]["logits"], "cpu")
    logits_fn = serve.served_logits(fn, (SIZE, SIZE), canvas_hw=canvas, flip=flip,
                                    scales=scales)
    with torch.inference_mode():
        got = logits_fn(torch.from_numpy(x)).numpy()
    if canvas is None:  # no tiling: the JAX composition without it
        fj = jtta.flip_avg(setup["jg"].apply)
        ref = np.asarray(fj(setup["variables"], jnp.asarray(x)))
    else:
        ref = _jax_logits(setup, x, flip=flip, scales=scales)
    assert got.shape == ref.shape == x.shape[:3] + (N_CLASSES,)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"max |logit diff| / max |logit| = {err:.2e}")
    assert err < TOL, err


def test_flip_and_scales_run_serve_matches_jax(setup, tmp_path):
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    serve.run_serve(setup["art"]["logits"], str(setup["imgs"]), str(ours), batch_size=3,
                    canvas_hw=CANVAS, flip=True, scales=SCALES, device="cpu")
    jserve.run_serve(setup["jlogits"], str(setup["imgs"]), str(ref), batch_size=3,
                     canvas_hw=CANVAS, flip=True, scales=SCALES)
    decisive = _decisive(_jax_logits(setup, _canvas_batch(setup["imgs"]), flip=True,
                                     scales=SCALES))
    assert decisive.mean() > 0.9
    got, want = _pngs(ours), _pngs(ref)
    for i, s in enumerate(STEMS):
        np.testing.assert_array_equal(got[s][decisive[i]], want[s][decisive[i]])


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_data_parallel_split_and_join_equals_one_replica(setup, n):
    one, _ = serve.build_predictor(setup["art"]["logits"], device="cpu", flip=True)
    two = serve.data_parallel_predictor([one, one])
    x = np.random.default_rng(n).normal(size=(n, SIZE, SIZE, 3)).astype(np.float32)
    got, want = two(x), one(x)
    assert got.shape == (n, SIZE, SIZE)
    assert torch.equal(got, want)
    assert serve.data_parallel_predictor([one]) is one


def test_serve_dp_on_the_cpu_is_the_single_device_path(setup, tmp_path):
    art, imgs = setup["art"]["logits"], str(setup["imgs"])
    serve.run_serve(art, imgs, str(tmp_path / "one"), batch_size=2, device="cpu")
    serve.run_serve(art, imgs, str(tmp_path / "dp"), batch_size=2, data_parallel=True,
                    device="cpu")
    for s in STEMS:
        assert ((tmp_path / "one" / f"{s}_pred.png").read_bytes()
                == (tmp_path / "dp" / f"{s}_pred.png").read_bytes())


# (artifact, options, words both messages carry)
REFUSALS = {
    "eval_resize": ("logits", dict(eval_resize="tile"), ("resize|center_crop",)),
    "scales_uint8": ("uint8", dict(scales=SCALES, canvas_hw=CANVAS), ("uint8", "float32")),
    "flip_segment": ("segment", dict(flip=True), ("--serve_flip", "logits")),
    "scales_no_canvas": ("logits", dict(scales=SCALES), ("--serve_scales", "tiled")),
    "canvas_segment": ("segment", dict(canvas_hw=CANVAS), ("tiled serving", "logits")),
    "canvas_small": ("logits", dict(canvas_hw=(SIZE, SIZE - 4)), ("smaller than",)),
    "scale_shrinks": ("logits", dict(canvas_hw=(SIZE, SIZE), scales=(0.5, 1.0)),
                      ("0.5", "smaller than")),
}


@pytest.fixture(scope="module")
def jax_artifacts(setup):
    jg = setup["jg"]

    def segment(p, x):
        return jnp.argmax(jg.apply(p, x), -1)

    u8 = jexport.uint8_input(lambda p, x: jg.apply(p, x))
    return {"logits": setup["jlogits"], "segment": setup["jart"]("jseg", segment, "segment"),
            "uint8": setup["jart"]("ju8", u8, "logits", jnp.uint8)}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(setup, jax_artifacts, case):
    which, opts, words = REFUSALS[case]
    with pytest.raises(ValueError) as ours:
        serve.build_predictor(setup["art"][which], device="cpu", **opts)
    with pytest.raises(ValueError) as ref:
        jserve.build_predictor(jax_artifacts[which], **opts)
    for w in words:
        assert w in str(ours.value) and w in str(ref.value), (w, ours.value, ref.value)


def test_generate_artifact_is_refused(setup, tmp_path):
    G = define_Gen(N_CLASSES, 3, NGF, f"resnet_{N_BLOCKS}blocks", head="tanh")
    art = export.export_generator(G, str(tmp_path / "gen"), gen_net=f"resnet_{N_BLOCKS}blocks",
                                  ngf=NGF, num_classes=N_CLASSES, in_channels=3,
                                  crop_hw=(SIZE, SIZE), dtype="float32", head="generate")
    with pytest.raises(ValueError, match="generate"):
        serve.run_serve(art, str(setup["imgs"]), str(tmp_path / "x"), device="cpu")


def test_http_info_and_flip_canvas_endpoint(setup, tmp_path):
    art = setup["art"]["logits"]
    opts = dict(canvas_hw=CANVAS, flip=True)
    serve.run_serve(art, str(setup["imgs"]), str(tmp_path / "ref"), device="cpu", **opts)
    server = make_server(art, port=0, device="cpu", max_batch=2, **opts)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/info", timeout=30) as r:
            info = json.load(r)
        req = urllib.request.Request(f"{base}/predict?format=mask",
                                     data=(setup["imgs"] / "a.png").read_bytes())
        with urllib.request.urlopen(req, timeout=60) as r:
            mask = np.asarray(Image.open(io.BytesIO(r.read())))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert info["tta"] == {"flip": True, "scales": None, "canvas_hw": list(CANVAS),
                           "data_parallel": False, "max_batch": 2}
    assert info["load_hw"] == list(CANVAS) and info["window_hw"] == [SIZE, SIZE]
    np.testing.assert_array_equal(mask, _pngs(tmp_path / "ref")["a"])


@pytest.mark.parametrize("net", ["unet_128", "resnet_bn"])
def test_unet_and_batch_norm_artifacts_match_jax(net, tmp_path):
    if net == "unet_128":
        size, jm = 128, JaxUnet(N_CLASSES, num_downs=7, ngf=4, head="none")
        tm = define_Gen(3, N_CLASSES, 4, "unet_128", head="none")
        gen_net, ngf, norm = "unet_128", 4, "instance"
    else:
        size, jm = SIZE, JaxResnetGenerator(output_nc=N_CLASSES, ngf=NGF, n_blocks=N_BLOCKS,
                                            norm="batch", head="none")
        tm = define_Gen(3, N_CLASSES, NGF, f"resnet_{N_BLOCKS}blocks", norm="batch",
                        head="none")
        gen_net, ngf, norm = f"resnet_{N_BLOCKS}blocks", NGF, "batch"
    v = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, size, size, 3))))
    if "batch_stats" in v:  # running averages away from the init's 0 / 1
        r = np.random.default_rng(2)
        v["batch_stats"] = jax.tree.map(
            lambda a: (r.uniform(0.5, 1.5, a.shape) if a.min() == 1.0
                       else r.normal(0, 0.05, a.shape)).astype(np.float32), v["batch_stats"])
    weights.load_flax_module(tm, v)
    art = export.export_generator(tm, str(tmp_path / net), gen_net=gen_net, ngf=ngf,
                                  num_classes=N_CLASSES, in_channels=3, crop_hw=(size, size),
                                  dtype="float32", head="segment", norm=norm,
                                  dataset="synthetic")
    imgs = _write_images(tmp_path / "imgs", (size + 8, size - 8), n=2)
    serve.run_serve(art, str(imgs), str(tmp_path / "out"), batch_size=2, device="cpu")
    for s in STEMS[:2]:
        x = jserve._load_image(str(imgs / f"{s}.png"), (size, size), 3, "resize")
        logits = np.asarray(jm.apply(v, jnp.asarray(x[None])))[0]
        decisive = _decisive(logits)
        assert decisive.mean() > 0.9
        got = np.asarray(Image.open(tmp_path / "out" / f"{s}_pred.png"))
        np.testing.assert_array_equal(got[decisive], logits.argmax(-1)[decisive])
