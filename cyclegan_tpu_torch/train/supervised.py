"""Supervised segmentation trainer (reference ``supervised_model``).

Counterpart of ``cyclegan_tpu/train/supervised.py``: one generator as the
segmentation net (raw logits head), pixel cross-entropy ignoring 255, Adam
with the LambdaLR staircase. A train step runs the net in train mode:
dropout from the state's device generator when configured, batch norm on
the batch's statistics with its running averages moved by the forward
(the JAX step's ``batch_stats`` write-back). ``logits``, ``eval_step`` and
``predict`` run it in eval mode. Batches use the JAX package's layout:
images (B, H, W, C) float32, labels (B, H, W) integers; the metrics come
from the pre-update parameters, as detached float32 tensors. With a data
``mesh`` of k ranks each steps on its B/k rows (and, under a spatial axis,
its H slab of them) and the update is the one-device update on the global
batch (as ``train/cyclegan.py`` says).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from cyclegan_tpu_torch.models import define_Gen
from cyclegan_tpu_torch.ops.blocks import set_data_mesh
from cyclegan_tpu_torch.ops.init import init_weights
from cyclegan_tpu_torch.parallel.mesh import Mesh, all_reduce_mean, mean_metrics
from cyclegan_tpu_torch.train import losses, metrics, schedule
from cyclegan_tpu_torch.train.cyclegan import (_nchw, _nhwc, _stack_size, ce_count,
                                               check_rows, data_mesh, eval_mode)
from cyclegan_tpu_torch.utils.config import Config


@dataclasses.dataclass
class SupervisedState:
    """What a step carries besides the net (which holds the parameters and
    the batch norms' running averages): Adam, its LambdaLR, the dropout
    generator (on the trainer's device), the step count and the seed the
    dropout generator was made from."""
    opt: torch.optim.Adam
    sched: torch.optim.lr_scheduler.LambdaLR
    dropout: torch.Generator
    step: int = 0
    dropout_seed: int = 0


class SupervisedTrainer:
    """Builds the segmentation net on ``device`` (default: the CUDA device;
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
        self.model = define_Gen(in_channels, num_classes, cfg.ngf, cfg.gen_net, cfg.norm,
                                head="none", dtype=self.dtype, use_dropout=cfg.use_dropout,
                                remat=cfg.remat)
        self.model.to(self.device, memory_format=torch.channels_last).train()
        set_data_mesh(self.model, self.mesh, cfg.batch_size // self.mesh.dp)
        self.ignore_index = 255

    def nets(self) -> tuple[nn.Module]:
        return (self.model,)

    def params(self) -> list[nn.Parameter]:
        return list(self.model.parameters())

    def init_state(self, generator: torch.Generator) -> SupervisedState:
        """Draw the net's weights from ``generator`` (N(0, 0.02)), then build
        Adam with its LambdaLR and a dropout generator on the device seeded
        from ``generator``."""
        cfg = self.cfg
        init_weights(self.model, generator)
        opt = schedule.make_adam(self.params(), cfg.lr)
        sched = schedule.make_scheduler(opt, epochs=cfg.epochs, decay_epoch=cfg.decay_epoch,
                                        steps_per_epoch=self.steps_per_epoch)
        drop_seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        return SupervisedState(opt=opt, sched=sched,
                               dropout=torch.Generator(device=self.device).manual_seed(drop_seed),
                               dropout_seed=drop_seed)

    def _loss(self, state: SupervisedState, batch: dict) -> torch.Tensor:
        check_rows(batch["image"].shape[0], self.cfg, self.mesh)
        drop = state.dropout if self.cfg.use_dropout else None
        count = ce_count(batch["label"], self.mesh, self.ignore_index)
        logits = self.model(_nchw(batch["image"]), drop)
        return losses.cross_entropy_loss(_nhwc(logits), batch["label"],
                                         ignore_index=self.ignore_index, count=count)

    def _update(self, state: SupervisedState, grads) -> None:
        """Apply ``grads`` (averaged over the ranks first) in one step."""
        for p, g in zip(self.params(), all_reduce_mean(list(grads), self.mesh)):
            p.grad = g
        state.opt.step()
        state.sched.step()
        state.step += 1

    def train_step(self, state: SupervisedState, batch: dict) -> tuple[SupervisedState, dict]:
        """One update on ``batch`` (image (B, H, W, C), label (B, H, W) int,
        on the trainer's device); the net, the optimizer and the batch
        norms' running averages are updated in place. Returns ``(state,
        {"ce_loss": ...})``."""
        loss = self._loss(state, batch)
        self._update(state, torch.autograd.grad(loss, self.params()))
        return state, mean_metrics({"ce_loss": loss.detach()}, self.mesh)

    def multi_step(self, state: SupervisedState, batches: dict) -> tuple[SupervisedState, dict]:
        """K chained train steps (``Config.steps_per_call``; ``batches``
        carries a leading K axis). Returns the last step's metrics."""
        metrics_ = {}
        for i in range(_stack_size(batches)):
            state, metrics_ = self.train_step(state, {k: v[i] for k, v in batches.items()})
        return state, metrics_

    def accum_step(self, state: SupervisedState, batches: dict) -> tuple[SupervisedState, dict]:
        """ONE update from K stacked microbatches (``Config.grad_accum``):
        the gradients of every microbatch at the same pre-update parameters,
        summed and divided by K; each microbatch's forward moves the batch
        norms' running averages in turn (K separate forwards); fresh dropout
        masks per microbatch. The loss is the mean over the microbatches."""
        k = _stack_size(batches)
        params = self.params()
        g_sum, l_sum = None, None
        for i in range(k):
            loss = self._loss(state, {key: v[i] for key, v in batches.items()})
            grads = torch.autograd.grad(loss, params)
            g_sum = list(grads) if g_sum is None else [s.add_(g) for s, g in zip(g_sum, grads)]
            l_sum = loss.detach() if l_sum is None else l_sum + loss.detach()
        self._update(state, [g / k for g in g_sum])
        return state, mean_metrics({"ce_loss": l_sum / k}, self.mesh)

    @torch.no_grad()
    def logits(self, image: torch.Tensor, rows: int | None = None) -> torch.Tensor:
        """Raw class logits (B, H, W, K) for images (B, H, W, C), in eval mode;
        under a spatial axis, this rank's slab of images of ``rows`` global
        rows (default: equal slabs)."""
        with eval_mode(self.model):
            return _nhwc(self.model(_nchw(image), rows=rows))

    @torch.no_grad()
    def eval_step(self, batch: dict) -> torch.Tensor:
        """Confusion-matrix contribution of one batch."""
        pred = self.logits(batch["image"]).argmax(-1)
        return metrics.confusion_matrix(pred, batch["label"], self.num_classes,
                                        ignore_index=self.ignore_index)

    @torch.no_grad()
    def predict(self, image: torch.Tensor) -> torch.Tensor:
        return self.logits(image).argmax(-1)
