"""Semi-supervised CycleGAN trainer (reference ``semisuper_cycleGAN``).

Counterpart of ``cyclegan_tpu/train/cyclegan.py``. One train step:

G phase (gradients w.r.t. the generators only; the discriminators are
constants of ``torch.autograd.grad`` and get no ``.grad``)::

  fake_lab  = softmax(G_i2l(unlab_img))        # the soft label bridge
  fake_img  = G_l2i(onehot(real_lab))
  adv       = MSE(D_lab(fake_lab), 1) + MSE(D_img(fake_img), 1)
  cycle_img = L1(G_l2i(fake_lab), unlab_img) * lamda
  cycle_lab = CE(G_i2l(fake_img), real_lab) * lamda_lab
  sup       = CE(G_i2l(lab_img), lab_gt)

With ``use_dropout`` every generator forward of the G phase draws fresh
dropout masks from the state's dropout generator (the JAX step's ``dkeys``);
``logits``, ``predict``, ``eval_step`` and ``generate_image`` never drop.

Pool phase: the detached fakes go through the replay pools.

D phase::

  0.5 * [MSE(D_img(real_img), 1) + MSE(D_img(pool_fake_img), 0)]
  0.5 * [MSE(D_lab(onehot(real_lab)), 1) + MSE(D_lab(pool_fake_lab), 0)]

As in the JAX step, applications of one network are concatenated along the
batch (instance norm is per sample, so this equals separate applies): G_i2l
on [unlab; lab], G_l2i on [onehot(lab); fake_lab], each D on [real; fake].
Batches use the JAX package's layout: images (B, H, W, C) float32, labels
(B, H, W) integers. Modules are NCHW over channels_last memory. The metrics
come from the pre-update parameters, as detached float32 tensors.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from cyclegan_tpu_torch.export import resolve_device
from cyclegan_tpu_torch.models import define_Dis, define_Gen
from cyclegan_tpu_torch.ops.init import init_weights
from cyclegan_tpu_torch.train import losses, metrics, schedule
from cyclegan_tpu_torch.train.pool import (PoolState, init_pool, pool_query,
                                           pool_query_with_decisions)
from cyclegan_tpu_torch.utils.config import Config

POOL_KEYS = ("pool_use_new_img", "pool_idx_img", "pool_use_new_lab", "pool_idx_lab")


@dataclasses.dataclass
class CycleGANState:
    """What a step carries besides the trainer's modules (which hold the
    parameters): the two Adams and their LambdaLRs, the replay pools, the
    generator of the pool decisions, the generator of the dropout masks (on
    the trainer's device), and the step count."""
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    g_sched: torch.optim.lr_scheduler.LambdaLR
    d_sched: torch.optim.lr_scheduler.LambdaLR
    pool_img: PoolState
    pool_lab: PoolState
    generator: torch.Generator
    dropout: torch.Generator
    step: int = 0


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _stack_size(batches: dict) -> int:
    """K of a dict of batches stacked along a leading axis."""
    return int(next(iter(batches.values())).shape[0])


def _accumulate(sums: dict, metrics_: dict) -> None:
    """Add detached float32 metrics into ``sums``, key by key."""
    for key, v in metrics_.items():
        v = v.detach().float()
        sums[key] = v if key not in sums else sums[key] + v


class CycleGANTrainer:
    """Builds the four networks on ``device`` (default: the CUDA device;
    without one this raises rather than run on the CPU)."""

    def __init__(self, cfg: Config, num_classes: int, in_channels: int,
                 steps_per_epoch: int, device: str | torch.device | None = None):
        if cfg.remat:
            raise NotImplementedError("remat (torch.utils.checkpoint of the trunks) "
                                      "arrives with a later slice of the port")
        self.cfg = cfg
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.steps_per_epoch = steps_per_epoch
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if cfg.bf16 else torch.float32
        d = self.dtype
        self.G_i2l = define_Gen(in_channels, num_classes, cfg.ngf, cfg.gen_net, cfg.norm,
                                head="none", dtype=d, use_dropout=cfg.use_dropout)
        self.G_l2i = define_Gen(num_classes, in_channels, cfg.ngf, cfg.gen_net, cfg.norm,
                                head="tanh", dtype=d, use_dropout=cfg.use_dropout)
        self.D_img = define_Dis(in_channels, cfg.ndf, cfg.dis_net, cfg.n_layers_D,
                                cfg.norm, dtype=d)
        self.D_lab = define_Dis(num_classes, cfg.ndf, cfg.dis_net, cfg.n_layers_D,
                                cfg.norm, dtype=d)
        for net in self.nets():
            net.to(self.device, memory_format=torch.channels_last).train()
        self.ignore_index = 255
        self.lamda = cfg.lamda
        self.lamda_lab = cfg.lamda if cfg.lamda_lab is None else cfg.lamda_lab

    def nets(self) -> tuple[nn.Module, nn.Module, nn.Module, nn.Module]:
        return self.G_i2l, self.G_l2i, self.D_img, self.D_lab

    def g_params(self) -> list[nn.Parameter]:
        return [*self.G_i2l.parameters(), *self.G_l2i.parameters()]

    def d_params(self) -> list[nn.Parameter]:
        return [*self.D_img.parameters(), *self.D_lab.parameters()]

    def init_state(self, generator: torch.Generator) -> CycleGANState:
        """Draw all four networks' weights from ``generator`` (N(0, 0.02),
        in the order G_i2l, G_l2i, D_img, D_lab), then build the optimizers,
        the empty pools (compute type, on the device), a pool-decision
        generator and a dropout generator on the device, both seeded from
        ``generator``."""
        cfg = self.cfg
        for net in self.nets():
            init_weights(net, generator)
        sched = dict(epochs=cfg.epochs, decay_epoch=cfg.decay_epoch,
                     steps_per_epoch=self.steps_per_epoch)
        g_opt = schedule.make_adam(self.g_params(), cfg.lr)
        d_opt = schedule.make_adam(self.d_params(), cfg.lr)
        h, w = cfg.crop_height, cfg.crop_width
        pool = dict(dtype=self.dtype, device=self.device)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        drop_seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        return CycleGANState(
            g_opt=g_opt, d_opt=d_opt,
            g_sched=schedule.make_scheduler(g_opt, **sched),
            d_sched=schedule.make_scheduler(d_opt, **sched),
            pool_img=init_pool(cfg.pool_size, (h, w, self.in_channels), **pool),
            pool_lab=init_pool(cfg.pool_size, (h, w, self.num_classes), **pool),
            generator=torch.Generator().manual_seed(seed),
            dropout=torch.Generator(device=self.device).manual_seed(drop_seed))

    def _onehot(self, labels: torch.Tensor) -> torch.Tensor:
        """(B, H, W) labels -> (B, H, W, K) float32 one-hot, all-zero on void."""
        valid = labels != self.ignore_index
        oh = nn.functional.one_hot(torch.where(valid, labels, 0).long(), self.num_classes)
        return oh.float() * valid.unsqueeze(-1)

    def _g_loss(self, batch: dict, real_lab_oh: torch.Tensor,
                drop: torch.Generator | None):
        b = batch["unlab_image"].shape[0]
        seg_out = self.G_i2l(_nchw(torch.cat([batch["unlab_image"], batch["lab_image"]])),
                             drop)
        fake_lab = torch.softmax(seg_out[:b], dim=1)
        sup_logits = seg_out[b:]
        l2i_out = self.G_l2i(_nchw(torch.cat([real_lab_oh, _nhwc(fake_lab).float()])), drop)
        fake_img, rec_img = l2i_out[:b], l2i_out[b:]
        adv_lab = losses.lsgan_loss(self.D_lab(fake_lab), True)
        adv_img = losses.lsgan_loss(self.D_img(fake_img), True)
        cyc_img = losses.l1_loss(_nhwc(rec_img), batch["unlab_image"]) * self.lamda
        rec_lab_logits = self.G_i2l(fake_img, drop)
        cyc_lab = losses.cross_entropy_loss(_nhwc(rec_lab_logits), batch["lab_label"],
                                            ignore_index=self.ignore_index) * self.lamda_lab
        sup = losses.cross_entropy_loss(_nhwc(sup_logits), batch["lab_label"],
                                        ignore_index=self.ignore_index)
        total = adv_lab + adv_img + cyc_img + cyc_lab + sup
        aux = {"g_adv": adv_lab + adv_img, "g_cycle_img": cyc_img, "g_cycle_lab": cyc_lab,
               "g_sup": sup, "g_total": total}
        return total, aux, _nhwc(fake_img).detach(), _nhwc(fake_lab).detach()

    def _d_loss(self, batch: dict, real_lab_oh: torch.Tensor, pooled_fake_img: torch.Tensor,
                pooled_fake_lab: torch.Tensor):
        b = batch["unlab_image"].shape[0]
        img = batch["unlab_image"]
        s_img = self.D_img(_nchw(torch.cat([img, pooled_fake_img.to(img.dtype)])))
        d_img_loss = 0.5 * (losses.lsgan_loss(s_img[:b], True)
                            + losses.lsgan_loss(s_img[b:], False))
        s_lab = self.D_lab(_nchw(torch.cat([real_lab_oh,
                                            pooled_fake_lab.to(real_lab_oh.dtype)])))
        d_lab_loss = 0.5 * (losses.lsgan_loss(s_lab[:b], True)
                            + losses.lsgan_loss(s_lab[b:], False))
        total = d_img_loss + d_lab_loss
        return total, {"d_img": d_img_loss, "d_lab": d_lab_loss, "d_total": total}

    def _pool(self, state: CycleGANState, batch: dict, fake_img: torch.Tensor,
              fake_lab: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        given = [k for k in POOL_KEYS if k in batch]
        if given and len(given) != len(POOL_KEYS):
            raise ValueError(f"injected pool decisions require all four batch keys "
                             f"{POOL_KEYS}; got only {given}")
        if self.cfg.pool_size == 0:
            return fake_img, fake_lab
        if given:
            state.pool_img, fake_img = pool_query_with_decisions(
                state.pool_img, fake_img, batch["pool_use_new_img"], batch["pool_idx_img"])
            state.pool_lab, fake_lab = pool_query_with_decisions(
                state.pool_lab, fake_lab, batch["pool_use_new_lab"], batch["pool_idx_lab"])
        else:
            state.pool_img, fake_img = pool_query(state.pool_img, fake_img, state.generator)
            state.pool_lab, fake_lab = pool_query(state.pool_lab, fake_lab, state.generator)
        return fake_img, fake_lab

    @staticmethod
    def _update(params: list[nn.Parameter], grads, opt, sched) -> None:
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        sched.step()

    def train_step(self, state: CycleGANState, batch: dict) -> tuple[CycleGANState, dict]:
        """One alternating G/D update. ``batch``: lab_image (B, H, W, C),
        lab_label (B, H, W) int, unlab_image (B, H, W, C), on the trainer's
        device, and optionally all four injected pool-decision keys. Updates
        the modules, optimizers and pools in place; returns ``(state,
        metrics)``."""
        real_lab_oh = self._onehot(batch["lab_label"])
        drop = state.dropout if self.cfg.use_dropout else None
        g_total, aux, fake_img, fake_lab = self._g_loss(batch, real_lab_oh, drop)
        g_params = self.g_params()
        self._update(g_params, torch.autograd.grad(g_total, g_params),
                     state.g_opt, state.g_sched)
        metrics_ = {k: v.detach() for k, v in aux.items()}
        pooled_img, pooled_lab = self._pool(state, batch, fake_img, fake_lab)
        d_total, d_aux = self._d_loss(batch, real_lab_oh, pooled_img, pooled_lab)
        d_params = self.d_params()
        self._update(d_params, torch.autograd.grad(d_total, d_params),
                     state.d_opt, state.d_sched)
        state.step += 1
        metrics_.update((k, v.detach()) for k, v in d_aux.items())
        return state, metrics_

    def multi_step(self, state: CycleGANState, batches: dict) -> tuple[CycleGANState, dict]:
        """K chained train steps (``Config.steps_per_call``): ``batches``
        carries a leading K axis (images (K, B, H, W, C), labels (K, B, H,
        W)). Returns the last step's metrics, as the JAX ``lax.scan`` does."""
        metrics_ = {}
        for i in range(_stack_size(batches)):
            state, metrics_ = self.train_step(state, {k: v[i] for k, v in batches.items()})
        return state, metrics_

    def accum_step(self, state: CycleGANState, batches: dict) -> tuple[CycleGANState, dict]:
        """ONE alternating G/D update from K stacked microbatches
        (``Config.grad_accum``; ``batches`` as in :meth:`multi_step`).

        As the JAX ``accum_step``: the G gradients of every microbatch are
        taken at the same pre-update parameters, summed, divided by K and
        applied in one Adam step; each microbatch draws fresh dropout masks;
        the pools are queried once per microbatch, in order (the replay
        stream therefore differs from one query of the K*B batch); the D
        phase starts from the D the G phase saw and averages its gradients
        the same way. Metrics are the means over the K microbatches. With
        equal valid-pixel counts per microbatch the losses equal one
        :meth:`train_step` on the concatenated batch."""
        k = _stack_size(batches)
        micro = [{key: v[i] for key, v in batches.items()} for i in range(k)]
        drop = state.dropout if self.cfg.use_dropout else None
        g_params, d_params = self.g_params(), self.d_params()
        onehots = [self._onehot(b["lab_label"]) for b in micro]
        g_sum, sums, fakes = None, {}, []
        for b, oh in zip(micro, onehots):
            g_total, aux, fake_img, fake_lab = self._g_loss(b, oh, drop)
            grads = torch.autograd.grad(g_total, g_params)
            g_sum = list(grads) if g_sum is None else [s.add_(g) for s, g in zip(g_sum, grads)]
            _accumulate(sums, aux)
            fakes.append((fake_img, fake_lab))
        self._update(g_params, [g / k for g in g_sum], state.g_opt, state.g_sched)
        del g_sum
        pooled = [self._pool(state, b, *f) for b, f in zip(micro, fakes)]
        d_sum = None
        for b, oh, (p_img, p_lab) in zip(micro, onehots, pooled):
            d_total, d_aux = self._d_loss(b, oh, p_img, p_lab)
            grads = torch.autograd.grad(d_total, d_params)
            d_sum = list(grads) if d_sum is None else [s.add_(g) for s, g in zip(d_sum, grads)]
            _accumulate(sums, d_aux)
        self._update(d_params, [g / k for g in d_sum], state.d_opt, state.d_sched)
        state.step += 1
        return state, {key: v / k for key, v in sums.items()}

    @torch.no_grad()
    def logits(self, image: torch.Tensor) -> torch.Tensor:
        """Raw class logits (B, H, W, K) of G_i2l for images (B, H, W, C)."""
        return _nhwc(self.G_i2l(_nchw(image)))

    @torch.no_grad()
    def eval_step(self, batch: dict) -> torch.Tensor:
        pred = self.logits(batch["image"]).argmax(-1)
        return metrics.confusion_matrix(pred, batch["label"], self.num_classes,
                                        ignore_index=self.ignore_index)

    @torch.no_grad()
    def predict(self, image: torch.Tensor) -> torch.Tensor:
        return self.logits(image).argmax(-1)

    @torch.no_grad()
    def generate_image(self, labels: torch.Tensor) -> torch.Tensor:
        """Label map (B, H, W) -> synthesized image (B, H, W, C)."""
        return _nhwc(self.G_l2i(_nchw(self._onehot(labels))))
