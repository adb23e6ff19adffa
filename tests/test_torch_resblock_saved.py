"""The fused residual block's backward from the residuals its forward kept, on the CPU.

On the CPU ``residual_block_fused`` runs its plain forward and VJP through
the same ``autograd.Function`` as on the card. When a gradient is wanted,
the forward keeps u, a, s and both norms' statistics, and the backward
starts at ``ds``: it runs no forward convolution and is bitwise the plain
VJP (``residual_block_bwd_saved_plain``) of the plain forward's residuals.
The JAX design recomputes them instead (``tests/test_torch_kernels_bwd.py``
holds the Function against it). A forward
without a gradient keeps nothing. Under the trunk's ``remat`` the
checkpoint reruns each block's forward once in the backward, and the
block's own backward recomputes nothing more. The kernels' route runs on
the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch.kernels import resblock as RB
from cyclegan_tpu_torch.ops.blocks import ResidualBlock
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.utils.config import Config


def _block(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]

    def t(s, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32)).to(dtype)

    return (t(shape), t((3, 3, c, c), 0.05), t((c,), 0.01), t((3, 3, c, c), 0.05),
            t((c,), 0.01), t(shape))


def _no_forward_conv(*_a, **_k):
    raise AssertionError("the fused block's backward ran a forward convolution")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (2, 16, 16, 48)])
def test_backward_from_saved_residuals_is_the_plain_vjp_of_the_plain_forward(
        shape, dtype, monkeypatch):
    x, w1, b1, w2, b2, dy = _block(shape, dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    y = RB.residual_block_fused(*leaves)
    assert torch.equal(y.detach(), RB.residual_block_plain(x, w1, b1, w2, b2))
    monkeypatch.setattr(RB, "_conv3x3_plain", _no_forward_conv)
    got = torch.autograd.grad(y, leaves, dy)
    monkeypatch.undo()
    r = RB.residual_block_fwd_plain(x, w1, b1, w2, b2)[1]
    dx, dw1, dw2 = RB.residual_block_bwd_saved_plain(x, dy, w1, w2, r)
    assert got[0].dtype == dtype and torch.equal(got[0], dx)
    assert torch.equal(got[1], dw1.to(dtype)) and torch.equal(got[3], dw2.to(dtype))
    assert torch.count_nonzero(got[2]) == 0 and torch.count_nonzero(got[4]) == 0


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode", "no_input_requires_grad"])
def test_forward_keeps_residuals_only_when_a_gradient_is_wanted(mode):
    """With a gradient: x, w1, w2 and the 7 residuals; without one (no
    grad mode, inference mode, or no input that requires grad): y has no
    grad_fn and nothing is saved."""
    x, w1, b1, w2, b2, _ = _block((1, 8, 8, 32), torch.float32)
    args = [t.requires_grad_(mode != "no_input_requires_grad") for t in (x, w1, b1, w2, b2)]
    saved = []
    grad_mode = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode}.get(
        mode, torch.enable_grad)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        with grad_mode():
            y = RB.residual_block_fused(*args)
    assert len(saved) == (3 + len(RB.Residuals._fields) if mode == "grad" else 0)
    assert (y.grad_fn is not None) == (mode == "grad")
    with torch.no_grad():
        assert torch.equal(y, RB.residual_block_plain(x, w1, b1, w2, b2))


KW = dict(gen_net="resnet_2blocks", ngf=4, ndf=4, crop_height=32, crop_width=32, bf16=False,
          pool_size=2, batch_size=2, epochs=200, decay_epoch=100)


def _batch(seed=5, n_classes=5, size=32):
    r = np.random.default_rng(seed)
    lab = r.integers(0, n_classes, (2, size, size)).astype(np.int32)
    lab[:, :3] = 255
    return {"lab_image": torch.from_numpy(r.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)),
            "unlab_image": torch.from_numpy(r.uniform(-1, 1, (2, size, size, 3))
                                            .astype(np.float32)),
            "lab_label": torch.from_numpy(lab)}


def _remat_step(remat: bool, monkeypatch):
    """One CycleGAN step on the fused route: (losses, gradients, forward
    calls of each trunk block, forward convolutions of the fused blocks)."""
    trainer = CycleGANTrainer(Config(remat=remat, **KW), 5, 3, 4, device="cpu")
    trunk = [b for net in (trainer.G_i2l, trainer.G_l2i) for b in net.modules()
             if isinstance(b, ResidualBlock)]
    assert trunk and all(b.route == "fused" for b in trunk)
    calls = [0] * len(trunk)
    for i, b in enumerate(trunk):
        b.register_forward_pre_hook(lambda *_a, i=i: calls.__setitem__(i, calls[i] + 1))
    convs = [0]
    conv = RB._conv3x3_plain

    def counted(*a):
        convs[0] += 1
        return conv(*a)

    state = trainer.init_state(torch.Generator().manual_seed(0))
    with monkeypatch.context() as m:
        m.setattr(RB, "_conv3x3_plain", counted)
        state, metrics = trainer.train_step(state, _batch())
    grads = {f"{i}.{n}": p.grad.clone() for i, net in enumerate(trainer.nets())
             for n, p in net.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads, calls, convs[0]


def test_fused_remat_is_bitwise_and_recomputes_each_block_once(monkeypatch):
    """``remat`` on the fused route (``tests/test_torch_remat.py`` covers the
    unfused one): bitwise the gradients of remat off; each trunk block's
    forward runs twice for each apply with a gradient (the checkpoint's
    rerun), and every fused forward convolution belongs to a block forward
    (two each): the block's backward recomputes nothing."""
    m_off, g_off, calls_off, convs_off = _remat_step(False, monkeypatch)
    m_on, g_on, calls_on, convs_on = _remat_step(True, monkeypatch)
    assert m_off == m_on
    assert g_off.keys() == g_on.keys()
    for k in g_off:
        assert torch.equal(g_off[k], g_on[k]), k
    assert all(n > 0 for n in calls_off)
    assert calls_on == [2 * n for n in calls_off]
    assert (convs_off, convs_on) == (2 * sum(calls_off), 2 * sum(calls_on))
