"""The port's reference-checkpoint bridge (``tools/torch_import_checkpoint.py``,
``tools/torch_export_checkpoint.py``), torch alone, on the CPU.

The counterparts of ``tests/test_checkpoint_import.py`` (2 cases) and
``tests/test_checkpoint_export.py`` (7), run on the port with the nets of
``tools/torch_reference.py``: imported weights reproduce the reference
nets' outputs and exported ones the port's (5e-5); Adam moments and steps
move both ways, bitwise (the layouts are torch's on both sides), and the
reference's Adam resumes from them; the CLIs drive a checkpoint of the
port out and back bitwise; a width mismatch raises. Besides: the port's
import of a ``latest.ckpt`` equals the JAX tool's import of the same file
bitwise, carried across by ``cyclegan_tpu_torch/weights.py``, and the
port's ``--training`` resumes from an imported checkpoint at the next
epoch.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.main import main as cli
from cyclegan_tpu_torch.train import checkpoint as ck
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.train.supervised import SupervisedTrainer
from cyclegan_tpu_torch.utils.config import Config
from tools import torch_export_checkpoint as exp_tool
from tools import torch_import_checkpoint as imp_tool
from tools.torch_reference import ResnetG, build, train_step

H = W = 32
N_CLASSES, NGF, NDF = 5, 8, 8
FLAGS = ["--dataset", "synthetic", "--gen_net", "resnet_6blocks", "--ngf", str(NGF),
         "--ndf", str(NDF), "--crop_height", str(H), "--crop_width", str(W),
         "--num_classes", str(N_CLASSES), "--pool_size", "2"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(**kw) -> Config:
    return Config(**{**dict(dataset="synthetic", gen_net="resnet_6blocks", ngf=NGF, ndf=NDF,
                            bf16=False, crop_height=H, crop_width=W, batch_size=2,
                            pool_size=2), **kw})


def _trainer(seed=0):
    t = CycleGANTrainer(_cfg(), N_CLASSES, 3, steps_per_epoch=2, device="cpu")
    return t, t.init_state(torch.Generator().manual_seed(seed))


def _torch_nets():
    torch.manual_seed(0)
    return build(N_CLASSES, 3, NGF, NDF, 6)


def _batch(seed=1):
    r = np.random.default_rng(seed)
    return {"lab_image": torch.from_numpy(r.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)),
            "unlab_image": torch.from_numpy(r.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)),
            "lab_label": torch.from_numpy(r.integers(0, N_CLASSES, (2, H, W)))}


def _nchw(x):
    return x.contiguous(memory_format=torch.channels_last)


def _inputs():
    x = torch.randn(1, 3, H, W, generator=torch.Generator().manual_seed(1))
    oh = torch.nn.functional.one_hot(
        torch.randint(0, N_CLASSES, (1, H, W), generator=torch.Generator().manual_seed(2)),
        N_CLASSES).permute(0, 3, 1, 2).float()
    return x, oh


def _assert_equal_sd(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _trained(steps=2):
    t, st = _trainer()
    for s in range(steps):
        st, _ = t.train_step(st, _batch(s))
    return t, st


# ------------------------------------------------ counterparts of the import tests
def test_import_reproduces_reference_outputs():
    refs = _torch_nets()
    t, _ = _trainer(seed=3)
    for ref, net in zip(refs, t.nets()):
        net.load_state_dict(imp_tool.import_net(ref.state_dict(), net.state_dict()))
    x, oh = _inputs()
    with torch.no_grad():
        for ref, net, inp in zip(refs, t.nets(), (x, oh, x, oh)):
            np.testing.assert_allclose(net(_nchw(inp)).numpy(), ref(inp).numpy(), atol=5e-5)


def test_import_adam_moments_roundtrip():
    """3 steps of the reference's Adam over both generators, imported into
    the port's g_opt: step 3, every moment bitwise."""
    torch.manual_seed(2)
    g_a, g_b = ResnetG(3, N_CLASSES, NGF, 6, tanh=False), ResnetG(N_CLASSES, 3, NGF, 6)
    opt = torch.optim.Adam(list(g_a.parameters()) + list(g_b.parameters()), lr=2e-4,
                           betas=(0.5, 0.999))
    for _ in range(3):
        loss = g_a(torch.randn(1, 3, H, W)).square().mean() \
            + g_b(torch.randn(1, N_CLASSES, H, W)).square().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    t, st = _trainer()
    new, step = imp_tool.import_adam_moments(
        opt.state_dict(), [g_a.state_dict(), g_b.state_dict()],
        [t.G_i2l.state_dict(), t.G_l2i.state_dict()], st.g_opt.state_dict())
    st.g_opt.load_state_dict(new)
    assert step == 3
    ours = [st.g_opt.state[p] for p in t.g_params()]
    theirs = [opt.state[p] for p in itertools.chain(g_a.parameters(), g_b.parameters())]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert int(a["step"]) == 3
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    assert float(ours[0]["exp_avg_sq"].max()) > 0


# ------------------------------------------------ counterparts of the export tests
def test_export_reproduces_port_outputs():
    t, _ = _trainer()
    refs = _torch_nets()
    for ref, net in zip(refs, t.nets()):
        ref.load_state_dict(exp_tool.export_net(net.state_dict(), ref.state_dict()))
    x, oh = _inputs()
    with torch.no_grad():
        for ref, net, inp in zip(refs, t.nets(), (x, oh, x, oh)):
            np.testing.assert_allclose(ref(inp).numpy(), net(_nchw(inp)).numpy(), atol=5e-5)


def test_export_import_roundtrip_bitwise():
    t, _ = _trainer()
    g_i2l, _, _, d_lab = _torch_nets()
    for net, ref in ((t.G_i2l, g_i2l), (t.D_lab, d_lab)):
        sd = exp_tool.export_net(net.state_dict(), ref.state_dict())
        _assert_equal_sd(imp_tool.import_net(sd, net.state_dict()), net.state_dict())


def test_exported_adam_state_resumes_torch(tmp_path):
    """The whole export: the reference loads the 4 nets and 2 Adams and
    takes a step from the port's step count; the moments come back through
    the importer bitwise."""
    t, st = _trained()
    out = str(tmp_path / "latest.ckpt")
    exp_tool.export_checkpoint(ck.state_payload(t, st), out, _cfg(), num_classes=N_CLASSES,
                               in_channels=3, epoch=7)
    ckpt = torch.load(out, map_location="cpu", weights_only=False)
    assert ckpt["epoch"] == 7 and set(ckpt) >= {"Gsi", "Gis", "Di", "Ds", "g_optimizer",
                                                 "d_optimizer"}
    back, step = imp_tool.import_adam_moments(
        ckpt["g_optimizer"], [ckpt["Gsi"], ckpt["Gis"]],
        [t.G_i2l.state_dict(), t.G_l2i.state_dict()], st.g_opt.state_dict())
    assert step == st.step == 2
    ours = st.g_opt.state_dict()["state"]
    assert back["state"].keys() == ours.keys()
    for i in ours:
        for f in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(back["state"][i][f], ours[i][f]), (i, f)

    refs = _torch_nets()
    for ref, name in zip(refs, ("Gsi", "Gis", "Di", "Ds")):
        ref.load_state_dict(ckpt[name])
    g_i2l, g_l2i, d_img, d_lab = refs
    g_opt = torch.optim.Adam(itertools.chain(g_i2l.parameters(), g_l2i.parameters()),
                             lr=2e-4, betas=(0.5, 0.999))
    d_opt = torch.optim.Adam(itertools.chain(d_img.parameters(), d_lab.parameters()),
                             lr=2e-4, betas=(0.5, 0.999))
    g_opt.load_state_dict(ckpt["g_optimizer"])
    d_opt.load_state_dict(ckpt["d_optimizer"])
    lab = torch.randint(0, N_CLASSES, (1, H, W))
    oh = torch.nn.functional.one_hot(lab, N_CLASSES).permute(0, 3, 1, 2).float()
    train_step(refs, (g_opt, d_opt), (torch.randn(1, 3, H, W), lab, torch.randn(1, 3, H, W),
                                      oh))
    assert int(g_opt.state_dict()["state"][0]["step"]) == st.step + 1


def _sup(seed=0):
    t = SupervisedTrainer(_cfg(), N_CLASSES, 3, steps_per_epoch=2, device="cpu")
    return t, t.init_state(torch.Generator().manual_seed(seed))


def test_supervised_export_roundtrip(tmp_path):
    """--model supervised: the one-net checkpoint reproduces the port's
    logits, the reference's Adam resumes from the port's moments, and the
    importer reads it back bitwise."""
    t, st = _sup()
    r = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(r.uniform(0, 1, (2, H, W, 3)).astype(np.float32)),
             "label": torch.from_numpy(r.integers(0, N_CLASSES, (2, H, W)))}
    for _ in range(2):
        st, _ = t.train_step(st, batch)
    out = str(tmp_path / "sup.ckpt")
    payload = ck.state_payload(t, st)
    exp_tool.export_supervised_checkpoint(payload, out, _cfg(), num_classes=N_CLASSES,
                                          in_channels=3, epoch=4)
    ckpt = torch.load(out, map_location="cpu", weights_only=False)
    assert ckpt["epoch"] == 4 and set(ckpt) >= {"Gsi", "g_optimizer"}
    g = ResnetG(3, N_CLASSES, NGF, 6, tanh=False)
    g.load_state_dict(ckpt["Gsi"])
    x, _ = _inputs()
    with torch.no_grad():
        np.testing.assert_allclose(g(x).numpy(), t.model(_nchw(x)).numpy(), atol=5e-5)
    opt = torch.optim.Adam(g.parameters(), lr=2e-4, betas=(0.5, 0.999))
    opt.load_state_dict(ckpt["g_optimizer"])
    torch.nn.functional.cross_entropy(g(x), torch.zeros(1, H, W, dtype=torch.long)).backward()
    opt.step()
    assert int(opt.state_dict()["state"][0]["step"]) == st.step + 1
    # Back through the importer (the file reloaded: opt.step() advanced the
    # step tensors it shares with `ckpt`).
    ckpt = torch.load(out, map_location="cpu", weights_only=False)
    back, epoch = imp_tool.import_checkpoint(ckpt, _cfg(), N_CLASSES, 3, supervised=True,
                                             device="cpu", say=lambda *a: None)
    assert epoch == 4 and back["step"] == st.step
    _assert_equal_sd(back["nets"]["model"], payload["nets"]["model"])
    for i, s in payload["opt"]["state"].items():
        for f in s:
            assert torch.equal(back["opt"]["state"][i][f], s[f]), (i, f)


def test_supervised_cli_tools_end_to_end(tmp_path):
    """A supervised checkpoint of the port -> the reference format through
    the export CLI -> a fresh directory through the import CLI: parameters
    bitwise, the next epoch 3."""
    t, st = _sup(seed=1)
    ck.CheckpointManager(str(tmp_path / "ckpt")).save(2, ck.state_payload(t, st))
    out = str(tmp_path / "sup.ckpt")
    exp_tool.main([str(tmp_path / "ckpt"), out, "--model", "supervised"] + FLAGS)
    assert torch.load(out, map_location="cpu", weights_only=False)["epoch"] == 2
    imp_tool.main([out, str(tmp_path / "back"), "--model", "supervised", "--device", "cpu"]
                  + FLAGS)
    t2, st2 = _sup(seed=9)
    restored = ck.CheckpointManager(str(tmp_path / "back")).restore(t2, st2)
    assert restored is not None and restored[1] == 3
    _assert_equal_sd(t2.model.state_dict(), t.model.state_dict())


def test_cli_tool_end_to_end(tmp_path):
    """A CycleGAN checkpoint of the port -> latest.ckpt through the export
    CLI -> a fresh directory through the import CLI: every net tensor,
    every Adam moment and the step bitwise."""
    t, st = _trained()
    payload = ck.state_payload(t, st)
    ck.CheckpointManager(str(tmp_path / "ckpt")).save(3, payload)
    out = str(tmp_path / "latest.ckpt")
    exp_tool.main([str(tmp_path / "ckpt"), out] + FLAGS)
    assert torch.load(out, map_location="cpu", weights_only=False)["epoch"] == 3
    imp_tool.main([out, str(tmp_path / "back"), "--device", "cpu"] + FLAGS)
    back, nxt = ck.CheckpointManager(str(tmp_path / "back")).restore()
    assert nxt == 4 and back["step"] == payload["step"] == 2
    for n in ck.NETS:
        _assert_equal_sd(back["nets"][n], payload["nets"][n])
    for opt in ("g_opt", "d_opt"):
        assert back[opt]["state"].keys() == payload[opt]["state"].keys()
        for i, s in payload[opt]["state"].items():
            for f in s:
                assert torch.equal(back[opt]["state"][i][f], s[f]), (opt, i, f)


def test_export_adam_moments_rejects_mismatched_widths():
    """Moments that fit no parameter (the wrong --ngf: the same count of
    layers, other shapes) raise instead of writing optimizer state that
    would break at the reference's first step."""
    t, st = _trained(1)
    torch.manual_seed(0)
    g_i2l, g_l2i, _, _ = build(N_CLASSES, 3, NGF * 2, NDF * 2, 6)
    opt = torch.optim.Adam(itertools.chain(g_i2l.parameters(), g_l2i.parameters()))
    with pytest.raises(ValueError, match="does not fit"):
        exp_tool.export_adam_moments(
            st.g_opt.state_dict(), [t.G_i2l.state_dict(), t.G_l2i.state_dict()],
            [g_i2l.state_dict(), g_l2i.state_dict()], opt.state_dict())


# ------------------------------------------------ against the JAX tool; resume
def _reference_ckpt(path, n_blocks=6, ngf=NGF, ndf=NDF, classes=N_CLASSES, epoch=5,
                    steps=2):
    """A reference latest.ckpt: torch_reference nets after ``steps`` of
    their own Adam steps."""
    torch.manual_seed(4)
    refs = build(classes, 3, ngf, ndf, n_blocks)
    g_opt = torch.optim.Adam(itertools.chain(refs[0].parameters(), refs[1].parameters()),
                             lr=2e-4, betas=(0.5, 0.999))
    d_opt = torch.optim.Adam(itertools.chain(refs[2].parameters(), refs[3].parameters()),
                             lr=2e-4, betas=(0.5, 0.999))
    for s in range(steps):
        lab = torch.randint(0, classes, (1, H, W))
        oh = torch.nn.functional.one_hot(lab, classes).permute(0, 3, 1, 2).float()
        train_step(refs, (g_opt, d_opt), (torch.randn(1, 3, H, W), lab,
                                          torch.randn(1, 3, H, W), oh))
    ckpt = {"epoch": epoch, "Gab": refs[0].state_dict(), "Gba": refs[1].state_dict(),
            "Da": refs[2].state_dict(), "Db": refs[3].state_dict(),
            "g_optimizer": g_opt.state_dict(), "d_optimizer": d_opt.state_dict()}
    torch.save(ckpt, path)
    return ckpt


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def test_port_import_matches_the_jax_tools_import_bitwise(tmp_path):
    """One latest.ckpt through both importers: the port's nets and
    g_opt moments, carried into Flax trees by weights.flax_variables, equal
    the JAX tool's params and optax moments bitwise, and the steps agree."""
    import jax

    from cyclegan_tpu.train.cyclegan import CycleGANTrainer as JaxCG
    from cyclegan_tpu.utils import config as jconfig
    from tools import import_torch_checkpoint as jax_tool

    ckpt = _reference_ckpt(tmp_path / "latest.ckpt")
    payload, epoch = imp_tool.import_checkpoint(ckpt, _cfg(), N_CLASSES, 3, device="cpu",
                                                say=lambda *a: None)
    jt = JaxCG(jconfig.Config(gen_net="resnet_6blocks", ngf=NGF, ndf=NDF, bf16=False,
                              crop_height=H, crop_width=W), N_CLASSES, 3, steps_per_epoch=1)
    js = jt.init_state(jax.random.PRNGKey(0))
    t, _ = _trainer()
    for name, key, attr in (("G_i2l", "Gab", "g_i2l"), ("G_l2i", "Gba", "g_l2i"),
                            ("D_img", "Da", "d_img"), ("D_lab", "Db", "d_lab")):
        net = getattr(t, name)
        net.load_state_dict(payload["nets"][name])
        want = _flat(jax.device_get(jax_tool.import_net(ckpt[key], getattr(js, attr))))
        got = _flat(weights.flax_variables(net))
        assert got.keys() == want.keys() and want, name
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}{k}")
    jopt = jax_tool.import_adam_moments(ckpt["g_optimizer"], [ckpt["Gab"], ckpt["Gba"]],
                                        [js.g_i2l, js.g_l2i], js.g_opt)
    assert int(jopt[0].count) == payload["step"] == 2 and epoch == 5
    state = payload["g_opt"]["state"]
    params = list(t.g_params())
    for field, jmoment in (("exp_avg", jopt[0].mu), ("exp_avg_sq", jopt[0].nu)):
        with torch.no_grad():  # the moments in the nets' places, carried into Flax trees
            for i, p in enumerate(params):
                p.copy_(state[i][field])
        for k, (net, tree) in enumerate(((t.G_i2l, jmoment[0]), (t.G_l2i, jmoment[1]))):
            got, want = _flat(weights.flax_variables(net)), _flat(jax.device_get(tree))
            assert got.keys() == want.keys()
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{field}{k}{key}")


def test_training_resumes_from_an_imported_reference_checkpoint(tmp_path, capsys):
    """A reference checkpoint of epoch 1 imported with the run's flags:
    --training resumes at epoch 2 from its step, with the LambdaLR of
    epoch 2."""
    _reference_ckpt(tmp_path / "latest.ckpt", n_blocks=2, ngf=4, ndf=4, classes=21, epoch=1,
                    steps=2)
    run = ["--dataset", "synthetic", "--dataset_size", "8", "--labeled_fraction", "0.5",
           "--gen_net", "resnet_2blocks", "--ngf", "4", "--ndf", "4", "--crop_height",
           str(H), "--crop_width", str(W), "--batch_size", "2", "--pool_size", "2",
           "--epochs", "3", "--decay_epoch", "1", "--checkpoint_dir", str(tmp_path / "ck")]
    imp_tool.main([str(tmp_path / "latest.ckpt"), str(tmp_path / "ck"), "--device", "cpu"]
                  + run)
    payload, nxt = ck.CheckpointManager(str(tmp_path / "ck")).restore()
    assert nxt == 2 and payload["step"] == 2
    # Epoch 2 of 3 with decay from epoch 1: the factor 1 - (2 - 1) / 2.
    lr = payload["g_opt"]["param_groups"][0]["lr"]
    assert lr == pytest.approx(2e-4 * 0.5) and payload["g_sched"]["last_epoch"] == 2
    capsys.readouterr()
    cli(["--training", "--device", "cpu", "--no_bf16", "--log_every", "1",
         "--validation_every", "0", "--results_dir", str(tmp_path / "res")] + run)
    assert "resumed from epoch 1" in capsys.readouterr().out
    logged = [json.loads(ln) for ln in open(tmp_path / "res" / "train_metrics.jsonl")]
    assert logged[0]["step"] == 3 and logged[0]["epoch"] == 2
    assert ck.CheckpointManager(str(tmp_path / "ck")).latest_epoch() == 2
