"""The port's export (``export.py``, ``--export``) against the JAX package,
on the CPU, at the serving tests' size (ngf 8, 2 trunk blocks, 5 classes,
32x32, float32).

- int8 and bf16 weight-only quantisation: the artifact's weights,
  dequantised, are bitwise the JAX ``dequantize_weights`` of the same Flax
  tree carried across (the int8 scale per output channel: axis 0 of a conv
  weight, axis 1 of a transposed conv's); the artifact is below 1/2.5
  (int8) and 1/1.5 (bf16) of the float32 one and serves nearly the same
  class maps;
- ``--export`` restores the newest checkpoint the port wrote: the
  ``logits`` and ``generate`` heads of a semi-supervised run within 5e-5
  (of the largest value) of the JAX ``logits`` and of the JAX ``generate``
  artifact from the same weights, and the supervised net's ``logits``;
  ``trained_steps`` is the state's step;
- ``--export --weights_npz --norm batch`` exports a batch-norm G_i2l with
  its running averages, and its logits are the JAX module's in eval mode
  within 5e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cyclegan_tpu import export as jexport
from cyclegan_tpu.models.generators import ResnetGenerator as JaxResnetGenerator
from cyclegan_tpu.train.cyclegan import CycleGANTrainer as JaxCycleGAN
from cyclegan_tpu.train.supervised import SupervisedTrainer as JaxSupervised
from cyclegan_tpu.utils import config as jconfig
from cyclegan_tpu_torch import export, main as cli, serve, weights
from cyclegan_tpu_torch.models.generators import ResnetGenerator
from cyclegan_tpu_torch.train.checkpoint import CheckpointManager, state_payload
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.train.supervised import SupervisedTrainer
from cyclegan_tpu_torch.utils import config as tconfig

N_CLASSES, NGF, NB, SIZE = 5, 8, 2, 32
TOL = 5e-5  # the generators' bar, of the largest value


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, ref, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < TOL, (what, err)


def _image(seed=0, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def g_i2l():
    jg = JaxResnetGenerator(output_nc=N_CLASSES, ngf=NGF, n_blocks=NB, head="none")
    v = jax.device_get(jg.init(jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 3))))
    tg = ResnetGenerator(3, N_CLASSES, NGF, NB, head="none")
    weights.load_flax_module(tg, v)
    return jg, v, tg


def _export(tg, path, **kw):
    return export.export_generator(tg, str(path), gen_net=f"resnet_{NB}blocks", ngf=NGF,
                                   num_classes=N_CLASSES, in_channels=3,
                                   crop_hw=(SIZE, SIZE), dtype="float32",
                                   dataset="synthetic", **kw)


@pytest.mark.parametrize("mode,size_bar", [("int8", 2.5), ("bf16", 1.5)])
def test_quantized_weights_are_bitwise_the_jax_dequantized_tree(g_i2l, tmp_path, mode,
                                                                size_bar):
    jg, v, tg = g_i2l
    ref = ResnetGenerator(3, N_CLASSES, NGF, NB, head="none")
    weights.load_flax_module(ref, jax.device_get(
        jexport.dequantize_weights(jexport.quantize_weights(v, mode=mode))))
    f32 = _export(tg, tmp_path / "f32", head="logits")
    q = _export(tg, tmp_path / mode, head="logits", quantize=mode)
    art, manifest = export.load_artifact(q)
    assert manifest["quantize"] == f"{mode}_weight_only"
    assert art["config"]["quantize"] == mode
    stored = {str(t.dtype) for t in art["state_dict"].values()}
    assert stored == {"torch.float32", "torch.int8" if mode == "int8" else "torch.bfloat16"}
    # The up-sampling transposed conv is quantised too (its scale on axis 1).
    assert art["state_dict"]["up1.conv.weight"].dtype != torch.float32
    if mode == "int8":
        assert art["scales"]["up1.conv.weight"].shape == (1, 2 * NGF, 1, 1)
    deq = export.dequantize_state(art["state_dict"], art["scales"])
    loaded = export.build_module(art, torch.device("cpu")).state_dict()
    for k, want in ref.state_dict().items():
        assert torch.equal(deq[k], want), k
        assert torch.equal(loaded[k], want), k
    assert os.path.getsize(q) < os.path.getsize(f32) / size_bar
    # Served: nearly the float32 artifact's class maps.
    x = _image(1)
    p32, _ = serve.build_predictor(f32, device="cpu")
    pq, _ = serve.build_predictor(q, device="cpu")
    assert (p32(x) == pq(x)).float().mean() > 0.9


def test_quantize_refuses_an_unknown_mode(g_i2l, tmp_path):
    with pytest.raises(ValueError, match="int8|bf16"):
        _export(g_i2l[2], tmp_path / "x", quantize="fp4")


def _cyclegan_checkpoint(ckpt_dir, step):
    kw = dict(ngf=NGF, ndf=NGF, crop_height=SIZE, crop_width=SIZE, bf16=False, pool_size=0,
              epochs=200, decay_epoch=100)
    jt = JaxCycleGAN(jconfig.Config(gen_net="resnet_6blocks", **kw), N_CLASSES, 3,
                     steps_per_epoch=1000)
    jt.G_i2l = jt.G_i2l.clone(n_blocks=NB)
    jt.G_l2i = jt.G_l2i.clone(n_blocks=NB)
    js = jt.init_state(jax.random.PRNGKey(0))
    tt = CycleGANTrainer(tconfig.Config(gen_net=f"resnet_{NB}blocks", **kw), N_CLASSES, 3,
                         steps_per_epoch=1000, device="cpu")
    ts = tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_cyclegan(tt, js)
    ts.step = step
    CheckpointManager(str(ckpt_dir)).save(1, state_payload(tt, ts))
    return jt, js


CLI = ["--gen_net", f"resnet_{NB}blocks", "--ngf", str(NGF), "--ndf", str(NGF),
       "--crop_height", str(SIZE), "--crop_width", str(SIZE), "--no_bf16", "--dataset",
       "synthetic", "--num_classes", str(N_CLASSES), "--pool_size", "0", "--device", "cpu"]


def test_cli_export_from_a_semisupervised_checkpoint(tmp_path):
    jt, js = _cyclegan_checkpoint(tmp_path / "ck", step=7)
    for what in ("logits", "generate"):
        cli.main(["--export", str(tmp_path / what), "--export_what", what,
                  "--checkpoint_dir", str(tmp_path / "ck"), *CLI])
    with open(tmp_path / "generate.json") as f:
        manifest = json.load(f)
    assert manifest["head"] == "generate" and manifest["trained_steps"] == 7
    x = _image(2)
    fn, cfg, _ = export.load_head(str(tmp_path / "logits.pt"), "cpu")
    _close(fn(torch.from_numpy(x)).numpy(), jt.logits(js.g_i2l, jnp.asarray(x)), "logits")

    labels = np.random.default_rng(4).integers(0, N_CLASSES, (2, SIZE, SIZE)).astype(np.int32)
    labels[:, :3] = 255  # void rows: an all-zero one-hot
    spec = jax.ShapeDtypeStruct(labels.shape, jnp.int32)
    jgen = jexport.export_closed(jt.generate_image, js.g_l2i, spec, platforms=("cpu",))
    ref = np.asarray(jgen.call(jnp.asarray(labels)))
    gen, cfg, _ = export.load_head(str(tmp_path / "generate.pt"), "cpu")
    got = gen(torch.from_numpy(labels)).numpy()
    assert got.shape == (2, SIZE, SIZE, 3) and np.abs(got).max() <= 1.0
    _close(got, ref, "generate")
    with pytest.raises(ValueError, match="uint8"):
        cli.main(["--export", str(tmp_path / "g8"), "--export_what", "generate",
                  "--export_input", "uint8", "--checkpoint_dir", str(tmp_path / "ck"), *CLI])


def test_cli_export_from_a_supervised_checkpoint(tmp_path):
    kw = dict(ngf=NGF, crop_height=SIZE, crop_width=SIZE, bf16=False, epochs=200,
              decay_epoch=100)
    jt = JaxSupervised(jconfig.Config(gen_net="resnet_6blocks", **kw), N_CLASSES, 3,
                       steps_per_epoch=1000)
    jt.model = jt.model.clone(n_blocks=NB)
    js = jt.init_state(jax.random.PRNGKey(1))
    tt = SupervisedTrainer(tconfig.Config(gen_net=f"resnet_{NB}blocks", **kw), N_CLASSES, 3,
                           steps_per_epoch=1000, device="cpu")
    ts = tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_module(tt.model, js.params)
    ts.step = 3
    CheckpointManager(str(tmp_path / "ck")).save(0, state_payload(tt, ts))
    cli.main(["--export", str(tmp_path / "seg"), "--export_what", "logits", "--model",
              "supervised", "--checkpoint_dir", str(tmp_path / "ck"), *CLI])
    x = _image(5)
    fn, _, manifest = export.load_head(str(tmp_path / "seg.pt"), "cpu")
    assert manifest["trained_steps"] == 3
    _close(fn(torch.from_numpy(x)).numpy(), jt.logits(js.params, jnp.asarray(x)), "logits")
    with pytest.raises(ValueError, match="semi-supervised"):
        cli.main(["--export", str(tmp_path / "gen"), "--export_what", "generate", "--model",
                  "supervised", "--checkpoint_dir", str(tmp_path / "ck"), *CLI])


def test_cli_export_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        cli.main(["--export", str(tmp_path / "m"), "--checkpoint_dir", str(tmp_path / "none"),
                  *CLI])


def test_cli_export_of_a_batch_norm_npz_serves_its_running_averages(tmp_path):
    jg = JaxResnetGenerator(output_nc=N_CLASSES, ngf=NGF, n_blocks=NB, norm="batch",
                            head="none")
    v = jax.device_get(jg.init(jax.random.PRNGKey(2), jnp.zeros((1, SIZE, SIZE, 3))))
    r = np.random.default_rng(6)
    v["batch_stats"] = jax.tree.map(
        lambda a: (r.uniform(0.5, 1.5, a.shape) if a.min() == 1.0
                   else r.normal(0, 0.05, a.shape)).astype(np.float32), v["batch_stats"])
    flat = {"/".join(str(k.key) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(v)}
    assert any(k.startswith("batch_stats/") for k in flat)
    np.savez(tmp_path / "g.npz", **flat)
    cli.main(["--export", str(tmp_path / "bn"), "--export_what", "logits", "--weights_npz",
              str(tmp_path / "g.npz"), "--norm", "batch", *CLI])
    art, _ = export.load_artifact(str(tmp_path / "bn.pt"))
    assert art["config"]["norm"] == "batch"
    x = _image(7)
    fn, _, _ = export.load_head(str(tmp_path / "bn.pt"), "cpu")
    _close(fn(torch.from_numpy(x)).numpy(), jg.apply(v, jnp.asarray(x)), "batch-norm logits")
    # ... and as served class maps.
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    raw = ((x + 1) * 127.5).round().astype(np.uint8)
    for i, im in enumerate(raw):
        Image.fromarray(im).save(imgs / f"{i}.png")
    predict, _ = serve.build_predictor(str(tmp_path / "bn.pt"), device="cpu")
    got = predict(serve.load_image(str(imgs / "0.png"), (SIZE, SIZE), 3, "resize")[None])
    ref = np.asarray(jg.apply(v, jnp.asarray(serve.load_image(
        str(imgs / "0.png"), (SIZE, SIZE), 3, "resize")[None])))
    top2 = np.sort(ref, -1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 1e-4
    np.testing.assert_array_equal(got.numpy()[decisive], ref.argmax(-1)[decisive])
