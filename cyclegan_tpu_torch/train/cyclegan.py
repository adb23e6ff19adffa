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
Under ``norm='batch'`` the statistics would couple the halves, so each
network is applied separately, in the reference's order (G_i2l(unlab),
G_l2i(onehot), G_l2i(fake_lab), D_lab, D_img, G_i2l(fake_img),
G_i2l(lab); then D_img real, fake, D_lab real, fake): the batch norms'
running averages move with every train-mode forward, the discriminators'
in the G phase too, and that order decides them. ``logits``, ``predict``,
``eval_step`` and ``generate_image`` run the nets in eval mode (running
averages). Batches use the JAX package's layout: images (B, H, W, C)
float32, labels (B, H, W) integers. Modules are NCHW over channels_last
memory. The metrics come from the pre-update parameters, as detached
float32 tensors.

With a data ``mesh`` of k ranks (``parallel.mesh``) each rank steps on its
B/k rows of the global batch of B = ``cfg.batch_size``, and the step is the
one-device step on the global batch, as the JAX step under a sharded jit
is: the cross-entropies divide by the global batch's valid pixels, the
gradients and metrics are averaged over the ranks, batch norms take global
statistics, dropout masks are the global batch's rows, and the fakes of
the global batch go through every rank's copy of the pools with the same
decisions (injected ones are (B,) vectors of the global batch).

Under a spatial axis of s ranks (``mesh.spatial``) each rank of a data row
holds an equal H slab of its rows: the nets run on slabs
(``ops.blocks.set_data_mesh``), every mean (the LSGAN patch maps, whose
slabs may differ in height, and the L1 cycle) divides this slab's sum by
the whole plane's count, the cross-entropies divide by the global batch's
valid pixels over the data ranks, the gradients and metrics are summed
over the world and divided by the data ranks, and each rank's pools hold
its slabs of every pooled image (every rank takes the same decisions; the
rows of the global batch are gathered over the data group).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn

from cyclegan_tpu_torch.export import resolve_device
from cyclegan_tpu_torch.models import define_Dis, define_Gen
from cyclegan_tpu_torch.ops.blocks import set_data_mesh
from cyclegan_tpu_torch.ops.init import init_weights
from cyclegan_tpu_torch.parallel.mesh import (Mesh, all_reduce_mean, all_reduce_sum,
                                              gather_rows, local_rows, mean_metrics)
from cyclegan_tpu_torch.train import losses, metrics, schedule
from cyclegan_tpu_torch.train.pool import (PoolState, init_pool, pool_query,
                                           pool_query_with_decisions)
from cyclegan_tpu_torch.utils.config import Config
from cyclegan_tpu_torch.utils.observability import span

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
    dropout_seed: int = 0


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@contextlib.contextmanager
def eval_mode(*nets: nn.Module):
    """Run ``nets`` in eval mode (batch norms on their running averages,
    no dropout) for the block, then back in the mode each was in."""
    modes = [n.training for n in nets]
    for n in nets:
        n.eval()
    try:
        yield
    finally:
        for n, m in zip(nets, modes):
            n.train(m)


def _stack_size(batches: dict) -> int:
    """K of a dict of batches stacked along a leading axis."""
    return int(next(iter(batches.values())).shape[0])


def data_mesh(cfg: Config, device, mesh: Mesh | None) -> Mesh:
    """The trainer's mesh: ``mesh``, or this device alone. Its data ranks
    must divide the global batch."""
    mesh = mesh or Mesh(resolve_device(device))
    if cfg.batch_size % mesh.dp:
        raise ValueError(f"batch_size {cfg.batch_size} (the global batch) does not divide "
                         f"over {mesh.dp} ranks")
    return mesh


def check_rows(rows: int, cfg: Config, mesh: Mesh) -> None:
    """A rank steps on its share of the global batch, no other size."""
    if mesh.dp > 1 and rows * mesh.dp != cfg.batch_size:
        raise ValueError(f"a rank's batch has {rows} rows; the global batch_size "
                         f"{cfg.batch_size} over {mesh.dp} ranks gives "
                         f"{cfg.batch_size // mesh.dp}")


def ce_count(labels: torch.Tensor, mesh: Mesh, ignore_index: int) -> torch.Tensor | None:
    """A rank's cross-entropy divisor: the global batch's valid pixels (at
    least 1) over the data ranks, so that the ranks' losses sum over each
    spatial group and average over the data axis to the global mean; None
    (the batch's own count) at world 1."""
    if mesh.world == 1:
        return None
    valid = all_reduce_sum((labels != ignore_index).sum(), mesh)
    return valid.clamp_min(1) / mesh.dp


def plane_count(mesh: Mesh, t: torch.Tensor, rows: int | None = None) -> int | None:
    """The divisor of a mean over NCHW ``t`` on an H slab: the elements of
    this rank's rows of the whole plane of ``rows`` global rows (default:
    ``t``'s equal slabs); None (``t``'s own count) without a spatial axis."""
    if mesh.spatial == 1:
        return None
    n, c, h, w = t.shape
    return n * c * w * (h * mesh.spatial if rows is None else rows)


def _accumulate(sums: dict, metrics_: dict) -> None:
    """Add detached float32 metrics into ``sums``, key by key."""
    for key, v in metrics_.items():
        v = v.detach().float()
        sums[key] = v if key not in sums else sums[key] + v


class CycleGANTrainer:
    """Builds the four networks on ``device`` (default: the CUDA device;
    without one this raises rather than run on the CPU), or on the device
    of ``mesh``, this rank's place in a data-parallel group."""

    def __init__(self, cfg: Config, num_classes: int, in_channels: int,
                 steps_per_epoch: int, device: str | torch.device | None = None,
                 mesh: Mesh | None = None):
        self.cfg = cfg
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.steps_per_epoch = steps_per_epoch
        self.mesh = data_mesh(cfg, device, mesh)
        self.device = self.mesh.device
        self.dtype = torch.bfloat16 if cfg.bf16 else torch.float32
        d = self.dtype
        self.G_i2l = define_Gen(in_channels, num_classes, cfg.ngf, cfg.gen_net, cfg.norm,
                                head="none", dtype=d, use_dropout=cfg.use_dropout,
                                remat=cfg.remat)
        self.G_l2i = define_Gen(num_classes, in_channels, cfg.ngf, cfg.gen_net, cfg.norm,
                                head="tanh", dtype=d, use_dropout=cfg.use_dropout,
                                remat=cfg.remat)
        self.D_img = define_Dis(in_channels, cfg.ndf, cfg.dis_net, cfg.n_layers_D,
                                cfg.norm, dtype=d)
        self.D_lab = define_Dis(num_classes, cfg.ndf, cfg.dis_net, cfg.n_layers_D,
                                cfg.norm, dtype=d)
        for net in self.nets():
            net.to(self.device, memory_format=torch.channels_last).train()
            set_data_mesh(net, self.mesh, cfg.batch_size // self.mesh.dp)
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
        h, w = cfg.crop_height // self.mesh.spatial, cfg.crop_width  # this rank's slab
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
            dropout=torch.Generator(device=self.device).manual_seed(drop_seed),
            dropout_seed=drop_seed)

    def _onehot(self, labels: torch.Tensor) -> torch.Tensor:
        """(B, H, W) labels -> (B, H, W, K) float32 one-hot, all-zero on void."""
        valid = labels != self.ignore_index
        oh = nn.functional.one_hot(torch.where(valid, labels, 0).long(), self.num_classes)
        return oh.float() * valid.unsqueeze(-1)

    def _adv(self, D: nn.Module, x: torch.Tensor, real: bool) -> torch.Tensor:
        """LSGAN of D on NCHW ``x``, a mean over the whole score map."""
        scores = D(x)
        rows = D.out_rows(x.shape[2] * self.mesh.spatial) if self.mesh.spatial > 1 else None
        return losses.lsgan_loss(scores, real, plane_count(self.mesh, scores, rows))

    def _g_loss(self, batch: dict, real_lab_oh: torch.Tensor,
                drop: torch.Generator | None):
        b = batch["unlab_image"].shape[0]
        check_rows(b, self.cfg, self.mesh)
        count = ce_count(batch["lab_label"], self.mesh, self.ignore_index)
        sup_logits = None
        if self.cfg.norm != "batch":
            seg_out = self.G_i2l(_nchw(torch.cat([batch["unlab_image"],
                                                  batch["lab_image"]])), drop)
            fake_lab = torch.softmax(seg_out[:b], dim=1)
            sup_logits = seg_out[b:]
            l2i_out = self.G_l2i(_nchw(torch.cat([real_lab_oh, _nhwc(fake_lab).float()])),
                                 drop)
            fake_img, rec_img = l2i_out[:b], l2i_out[b:]
        else:
            fake_lab = torch.softmax(self.G_i2l(_nchw(batch["unlab_image"]), drop), dim=1)
            fake_img = self.G_l2i(_nchw(real_lab_oh), drop)
            rec_img = self.G_l2i(fake_lab.float(), drop)
        adv_lab = self._adv(self.D_lab, fake_lab, True)
        adv_img = self._adv(self.D_img, fake_img, True)
        cyc_img = losses.l1_loss(_nhwc(rec_img), batch["unlab_image"],
                                 plane_count(self.mesh, rec_img)) * self.lamda
        rec_lab_logits = self.G_i2l(fake_img, drop)
        cyc_lab = losses.cross_entropy_loss(_nhwc(rec_lab_logits), batch["lab_label"],
                                            ignore_index=self.ignore_index,
                                            count=count) * self.lamda_lab
        if sup_logits is None:  # batch norm: after the label cycle, as the reference
            sup_logits = self.G_i2l(_nchw(batch["lab_image"]), drop)
        sup = losses.cross_entropy_loss(_nhwc(sup_logits), batch["lab_label"],
                                        ignore_index=self.ignore_index, count=count)
        total = adv_lab + adv_img + cyc_img + cyc_lab + sup
        aux = {"g_adv": adv_lab + adv_img, "g_cycle_img": cyc_img, "g_cycle_lab": cyc_lab,
               "g_sup": sup, "g_total": total}
        return total, aux, _nhwc(fake_img).detach(), _nhwc(fake_lab).detach()

    def _d_loss(self, batch: dict, real_lab_oh: torch.Tensor, pooled_fake_img: torch.Tensor,
                pooled_fake_lab: torch.Tensor):
        img = batch["unlab_image"]
        b = img.shape[0]
        d_losses = []
        rows = None
        for D, real, fake in ((self.D_img, img, pooled_fake_img),
                              (self.D_lab, real_lab_oh, pooled_fake_lab)):
            if self.cfg.norm != "batch":
                s = D(_nchw(torch.cat([real, fake.to(real.dtype)])))
                s_real, s_fake = s[:b], s[b:]
            else:
                s_real, s_fake = D(_nchw(real)), D(_nchw(fake))
            if self.mesh.spatial > 1:
                rows = D.out_rows(img.shape[1] * self.mesh.spatial)
            d_losses.append(0.5 * (
                losses.lsgan_loss(s_real, True, plane_count(self.mesh, s_real, rows))
                + losses.lsgan_loss(s_fake, False, plane_count(self.mesh, s_fake, rows))))
        d_img_loss, d_lab_loss = d_losses
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
        # Every rank queries its copy of the pools with the global batch (of
        # its slab) and the same decisions, then keeps its rows.
        fake_img, fake_lab = gather_rows(fake_img, self.mesh), gather_rows(fake_lab, self.mesh)
        if given:
            state.pool_img, fake_img = pool_query_with_decisions(
                state.pool_img, fake_img, batch["pool_use_new_img"], batch["pool_idx_img"])
            state.pool_lab, fake_lab = pool_query_with_decisions(
                state.pool_lab, fake_lab, batch["pool_use_new_lab"], batch["pool_idx_lab"])
        else:
            state.pool_img, fake_img = pool_query(state.pool_img, fake_img, state.generator)
            state.pool_lab, fake_lab = pool_query(state.pool_lab, fake_lab, state.generator)
        return local_rows(fake_img, self.mesh), local_rows(fake_lab, self.mesh)

    def _update(self, params: list[nn.Parameter], grads, opt, sched) -> None:
        """Apply ``grads`` (averaged over the ranks first) in one step."""
        for p, g in zip(params, all_reduce_mean(list(grads), self.mesh)):
            p.grad = g
        opt.step()
        sched.step()

    def train_step(self, state: CycleGANState, batch: dict) -> tuple[CycleGANState, dict]:
        """One alternating G/D update. ``batch``: lab_image (B, H, W, C),
        lab_label (B, H, W) int, unlab_image (B, H, W, C), on the trainer's
        device, and optionally all four injected pool-decision keys. Updates
        the modules, optimizers and pools in place; returns ``(state,
        metrics)``. Spans (``utils.observability``): ``train_step`` (unit:
        the step's number) over ``g_forward``, ``g_backward``, ``g_update``,
        ``pool``, ``d_forward``, ``d_backward``, ``d_update``."""
        with span("train_step", unit=state.step):
            real_lab_oh = self._onehot(batch["lab_label"])
            drop = state.dropout if self.cfg.use_dropout else None
            with span("g_forward"):
                g_total, aux, fake_img, fake_lab = self._g_loss(batch, real_lab_oh, drop)
            g_params = self.g_params()
            with span("g_backward"):
                grads = torch.autograd.grad(g_total, g_params)
            with span("g_update"):
                self._update(g_params, grads, state.g_opt, state.g_sched)
            metrics_ = {k: v.detach() for k, v in aux.items()}
            with span("pool"):
                pooled_img, pooled_lab = self._pool(state, batch, fake_img, fake_lab)
            with span("d_forward"):
                d_total, d_aux = self._d_loss(batch, real_lab_oh, pooled_img, pooled_lab)
            d_params = self.d_params()
            with span("d_backward"):
                grads = torch.autograd.grad(d_total, d_params)
            with span("d_update"):
                self._update(d_params, grads, state.d_opt, state.d_sched)
            state.step += 1
            metrics_.update((k, v.detach()) for k, v in d_aux.items())
            return state, mean_metrics(metrics_, self.mesh)

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
        :meth:`train_step` on the concatenated batch. Spans: one
        ``train_step`` root; ``g_forward``, ``g_backward``, ``pool``,
        ``d_forward`` and ``d_backward`` once a microbatch, ``g_update`` and
        ``d_update`` once."""
        k = _stack_size(batches)
        micro = [{key: v[i] for key, v in batches.items()} for i in range(k)]
        drop = state.dropout if self.cfg.use_dropout else None
        with span("train_step", unit=state.step):
            g_params, d_params = self.g_params(), self.d_params()
            onehots = [self._onehot(b["lab_label"]) for b in micro]
            g_sum, sums, fakes = None, {}, []
            for b, oh in zip(micro, onehots):
                with span("g_forward"):
                    g_total, aux, fake_img, fake_lab = self._g_loss(b, oh, drop)
                with span("g_backward"):
                    grads = torch.autograd.grad(g_total, g_params)
                g_sum = list(grads) if g_sum is None else [s.add_(g) for s, g in zip(g_sum, grads)]
                _accumulate(sums, aux)
                fakes.append((fake_img, fake_lab))
            with span("g_update"):
                self._update(g_params, [g / k for g in g_sum], state.g_opt, state.g_sched)
            del g_sum
            pooled = []
            for b, f in zip(micro, fakes):
                with span("pool"):
                    pooled.append(self._pool(state, b, *f))
            d_sum = None
            for b, oh, (p_img, p_lab) in zip(micro, onehots, pooled):
                with span("d_forward"):
                    d_total, d_aux = self._d_loss(b, oh, p_img, p_lab)
                with span("d_backward"):
                    grads = torch.autograd.grad(d_total, d_params)
                d_sum = list(grads) if d_sum is None else [s.add_(g) for s, g in zip(d_sum, grads)]
                _accumulate(sums, d_aux)
            with span("d_update"):
                self._update(d_params, [g / k for g in d_sum], state.d_opt, state.d_sched)
            state.step += 1
            return state, mean_metrics({key: v / k for key, v in sums.items()}, self.mesh)

    @torch.no_grad()
    def logits(self, image: torch.Tensor, rows: int | None = None) -> torch.Tensor:
        """Raw class logits (B, H, W, K) of G_i2l for images (B, H, W, C);
        under a spatial axis, this rank's slab of images of ``rows`` global
        rows (default: equal slabs)."""
        with eval_mode(self.G_i2l):
            return _nhwc(self.G_i2l(_nchw(image), rows=rows))

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
        with eval_mode(self.G_l2i):
            return _nhwc(self.G_l2i(_nchw(self._onehot(labels))))
