"""The reference train step of the semi-supervised CycleGAN, in float32.

One step (pre-update parameters for every loss; images and labels in the
benchmark's layout, NHWC float32 and (B, H, W) integers, 255 void)::

  G phase (gradients w.r.t. both generators; discriminators constant)
    seg       = G_i2l([unlab; lab])            masks drawn in this order:
    fake_lab  = softmax(seg[:B]);  sup_logits = seg[B:]
    out       = G_l2i([onehot(lab_label); fake_lab])
    fake_img  = out[:B];  rec_img = out[B:]
    g_adv     = MSE(D_lab(fake_lab), 1) + MSE(D_img(fake_img), 1)
    g_cycle_img = L1(rec_img, unlab) * lamda
    g_cycle_lab = CE(G_i2l(fake_img), lab_label) * lamda_lab
    g_sup     = CE(sup_logits, lab_label)
  pools: each fake goes through its replay pool (store while filling;
    then keep it with the given decision, else swap with the given slot)
  D phase
    d_img = 0.5 [MSE(D_img(unlab), 1) + MSE(D_img(pooled_img), 0)]
    d_lab = 0.5 [MSE(D_lab(onehot), 1) + MSE(D_lab(pooled_lab), 0)]

Cross-entropies average over the non-void pixels; every other loss is a
plain mean. Each phase ends in one Adam step (betas 0.5, 0.999, eps 1e-8)
at ``lr * factor``, the LambdaLR staircase factor of the step's epoch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import nets
from portbench.reference.precision import EXACT

IGNORE = 255
BETAS = (0.5, 0.999)
ADAM_EPS = 1e-8
LOSS_KEYS = ("g_adv", "g_cycle_img", "g_cycle_lab", "g_sup", "d_img", "d_lab")


def lambda_factor(update: int, *, epochs: int, decay_epoch: int, steps_per_epoch: int) -> float:
    """The learning-rate factor of the update with 0-based index ``update``:
    1 until ``decay_epoch``, then linear to 0 at ``epochs`` (clamped at 0),
    stepped once an epoch of ``steps_per_epoch`` updates."""
    epoch = update // steps_per_epoch
    return max(0.0, 1.0 - max(0.0, epoch - decay_epoch) / max(epochs - decay_epoch, 1))


def onehot(labels: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W) -> (B, H, W, K) float32, all zero on void pixels."""
    valid = labels != IGNORE
    return F.one_hot(torch.where(valid, labels, 0).long(), k).float() * valid.unsqueeze(-1)


def mse(scores: torch.Tensor, target: float) -> torch.Tensor:
    return (scores - target).square().mean()


def cross_entropy(logits_nchw: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits_nchw, dim=1)
    valid = labels != IGNORE
    picked = logp.gather(1, torch.where(valid, labels, 0).long().unsqueeze(1)).squeeze(1)
    return -(picked * valid).sum() / valid.sum().clamp_min(1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class Pool:
    """A replay pool of ``size`` images, the decisions given from outside;
    ``items`` its contents before the first query."""

    def __init__(self, size: int, items=()):
        self.size, self.items = size, list(items)[:size]

    def query(self, fakes: torch.Tensor, keep_new, slot) -> torch.Tensor:
        out = []
        for item, new, idx in zip(fakes, list(keep_new), list(slot)):
            if len(self.items) < self.size:
                self.items.append(item)
                out.append(item)
            elif new:
                out.append(item)
            else:
                out.append(self.items[int(idx)])
                self.items[int(idx)] = item
        return torch.stack(out)


class Adam:
    """Adam over a dict of tensors: m, v and a step count of its own."""

    def __init__(self, params: dict, lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict, factor: float) -> None:
        b1, b2 = BETAS
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / c2 ** 0.5 + ADAM_EPS
            p.sub_(self.lr * factor / c1 * self.m[k] / denom)


class ReferenceTrainer:
    """The four networks' parameters (float32, copies of ``weights``), the
    two Adams and the two pools (filled from ``pools``, the (P, H, W, C)
    images and (P, H, W, K) label maps); :meth:`step` is one train step,
    the first of them update ``first_update`` of the schedule."""

    def __init__(self, cfg: dict, weights: dict, *, q=EXACT, drop_seed: int | None = None,
                 pools: tuple | None = None, first_update: int = 0,
                 device: torch.device | str = "cpu"):
        self.cfg, self.q = cfg, q
        self.gen = nets.family(cfg["gen_net"])
        self.k = cfg["num_classes"]
        self.params = {net: {k: v.detach().to(device, torch.float32).clone().requires_grad_()
                             for k, v in w.items()} for net, w in weights.items()}
        g = {**{f"G_i2l.{k}": v for k, v in self.params["G_i2l"].items()},
             **{f"G_l2i.{k}": v for k, v in self.params["G_l2i"].items()}}
        d = {**{f"D_img.{k}": v for k, v in self.params["D_img"].items()},
             **{f"D_lab.{k}": v for k, v in self.params["D_lab"].items()}}
        self.g_opt, self.d_opt = Adam(g, cfg["lr"]), Adam(d, cfg["lr"])
        fills = [nchw(x.to(device)) for x in pools] if pools is not None else [(), ()]
        self.pool_img, self.pool_lab = (Pool(cfg["pool_size"], f) for f in fills)
        self.drop = None
        if cfg["use_dropout"]:
            self.drop = torch.Generator(device=device).manual_seed(drop_seed)
        self.updates = first_update

    def _factor(self) -> float:
        c = self.cfg
        return lambda_factor(self.updates, epochs=c["epochs"], decay_epoch=c["decay_epoch"],
                             steps_per_epoch=c["steps_per_epoch"])

    def _g(self, name, x, tanh):
        return self.gen.forward(self.params[name], x, self.cfg, tanh, self.q, self.drop)

    def _d(self, name, x):
        return nets.patchgan(self.params[name], x, self.cfg["n_layers_D"], self.q)

    def step(self, batch: dict, decisions: dict) -> tuple[dict, dict, dict]:
        """One train step. Returns ``(losses, g_grads, d_grads)``: the float
        losses of :data:`LOSS_KEYS` and the gradients each Adam got, by
        leaf name."""
        c = self.cfg
        lamda = c["lamda"]
        lamda_lab = lamda if c["lamda_lab"] is None else c["lamda_lab"]
        unlab, lab = nchw(batch["unlab_image"].float()), nchw(batch["lab_image"].float())
        labels = batch["lab_label"]
        b = unlab.shape[0]
        oh = nchw(onehot(labels, self.k))

        seg = self._g("G_i2l", torch.cat([unlab, lab]), False)
        fake_lab, sup_logits = torch.softmax(seg[:b], dim=1), seg[b:]
        out = self._g("G_l2i", torch.cat([oh, fake_lab]), True)
        fake_img, rec_img = out[:b], out[b:]
        g_adv = mse(self._d("D_lab", fake_lab), 1.0) + mse(self._d("D_img", fake_img), 1.0)
        g_cycle_img = (rec_img - unlab).abs().mean() * lamda
        g_cycle_lab = cross_entropy(self._g("G_i2l", fake_img, False), labels) * lamda_lab
        g_sup = cross_entropy(sup_logits, labels)
        g_total = g_adv + g_cycle_img + g_cycle_lab + g_sup
        names = list(self.g_opt.params)
        g_grads = dict(zip(names, torch.autograd.grad(g_total, list(self.g_opt.params.values()))))
        factor = self._factor()
        self.g_opt.step(g_grads, factor)

        pooled_img = self.pool_img.query(fake_img.detach(), decisions["pool_use_new_img"],
                                         decisions["pool_idx_img"])
        pooled_lab = self.pool_lab.query(fake_lab.detach(), decisions["pool_use_new_lab"],
                                         decisions["pool_idx_lab"])
        s = self._d("D_img", torch.cat([unlab, pooled_img]))
        d_img = 0.5 * (mse(s[:b], 1.0) + mse(s[b:], 0.0))
        s = self._d("D_lab", torch.cat([oh, pooled_lab]))
        d_lab = 0.5 * (mse(s[:b], 1.0) + mse(s[b:], 0.0))
        d_total = d_img + d_lab
        names = list(self.d_opt.params)
        d_grads = dict(zip(names, torch.autograd.grad(d_total, list(self.d_opt.params.values()))))
        self.d_opt.step(d_grads, factor)
        self.updates += 1
        losses = {"g_adv": g_adv, "g_cycle_img": g_cycle_img, "g_cycle_lab": g_cycle_lab,
                  "g_sup": g_sup, "d_img": d_img, "d_lab": d_lab}
        return {k: v.item() for k, v in losses.items()}, g_grads, d_grads

    def leaves(self) -> dict:
        """Every parameter by leaf name (``<net>.<param>``)."""
        return {**self.g_opt.params, **self.d_opt.params}
