"""Import a reference ``latest.ckpt`` into the port's checkpoint format.

The counterpart of ``tools/import_torch_checkpoint.py`` for
``cyclegan_tpu_torch``, in torch alone (no JAX: it runs where the port
runs). The reference saves one ``latest.ckpt`` dict: the epoch, the four
nets' state dicts (Gab/Gba/Da/Db, also keyed Gsi/Gis/Di/Ds) and two Adam
state dicts (SURVEY.md §3e). This tool loads the nets into the port's
trainer, maps both Adams' moments (``exp_avg``, ``exp_avg_sq``, ``step``)
onto the port's ``g_opt`` (both generators) and ``d_opt`` (both
discriminators), sets the LambdaLR to the epoch after the stored one, and
writes ``<epoch>.pt`` + ``<epoch>.json`` (``train/checkpoint.py``), which
``python -m cyclegan_tpu_torch.main --training`` with the same flags
resumes at the next epoch. A checkpoint without optimizer state gets fresh
moments, and the tool says so. The run's trainer is built on ``--device``
(the card unless ``cpu`` is asked for): the checkpoint's dropout generator
is that device's; a run on the other device type reseeds it
(``train/checkpoint.py::dropout_reseed``).

Usage:
  python tools/torch_import_checkpoint.py latest.ckpt ./checkpoints \\
      --preset voc_semisup_256 [--gen_net resnet_9blocks --ngf 64 ...] \\
      [--model supervised] [--epoch N] [--device cpu]

Every ``Config`` field is a flag, as on the port's CLI: pass the flags the
run will train with (the nets' shapes, the pools' crop and size, the
schedule). The port's layouts are torch's (conv OIHW, transposed conv (I,
O, kH, kW)), so the mapping pairs the conv layers of the two state dicts
in forward order (torch keeps registration order, so any Sequential-style
naming works) and checks every shape; an Adam's per-parameter state
follows the same order (each conv's weight, then its bias). Instance-norm
(affine-free) models only: a batch norm's parameters and running averages
have no place in the pairing.
"""

from __future__ import annotations

import argparse
import sys
import warnings
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cyclegan_tpu_torch.data.datasets import DATASET_SPECS  # noqa: E402
from cyclegan_tpu_torch.main import build_config, config_flag_types  # noqa: E402
from cyclegan_tpu_torch.train import schedule  # noqa: E402
from cyclegan_tpu_torch.train.checkpoint import CheckpointManager, state_payload  # noqa: E402
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer  # noqa: E402
from cyclegan_tpu_torch.train.supervised import SupervisedTrainer  # noqa: E402
from cyclegan_tpu_torch.utils.config import Config  # noqa: E402

# The reference's names of each net and optimizer, and the names others
# give them; the first one found is taken.
NET_KEYS = {"G_i2l": ("Gsi", "Gab", "G_A", "netG_A"), "G_l2i": ("Gis", "Gba", "G_B", "netG_B"),
            "D_img": ("Di", "Da", "D_A", "netD_A"), "D_lab": ("Ds", "Db", "D_B", "netD_B")}
SUPERVISED_KEYS = ("Gsi", "model", "net", "G", "state_dict")
OPT_KEYS = {"g_opt": ("g_optimizer", "g_opt", "optimizer_G"),
            "d_opt": ("d_optimizer", "d_opt", "optimizer_D")}
SUPERVISED_OPT_KEYS = ("g_optimizer", "optimizer", "opt")


def find(ckpt: dict, names: tuple[str, ...], what: str, required: bool = True):
    for n in names:
        if n in ckpt:
            return ckpt[n]
    if required:
        raise KeyError(f"no {what}: none of {names} in checkpoint keys {sorted(ckpt)}")
    return None


def conv_entries(sd: dict) -> list[tuple[str, str | None]]:
    """(weight key, bias key or None) of every conv layer of a state dict,
    in its key order (registration order, which is forward order)."""
    out = []
    for k, v in sd.items():
        if k.endswith(".weight") and v.ndim == 4:
            b = k[:-len("weight")] + "bias"
            out.append((k, b if b in sd else None))
    return out


def param_keys(sd: dict) -> list[str]:
    """The parameters of an affine-free net in registration order: each
    conv's weight, then its bias. Anything else (a batch norm's scale and
    running averages) raises: this mapping knows no place for it."""
    keys = [k for w, b in conv_entries(sd) for k in (w, b) if k is not None]
    other = sorted(set(sd) - set(keys))
    if other:
        raise ValueError(f"instance-norm (affine-free) models only; this state dict also "
                         f"holds {other[:4]}")
    return keys


def import_net(src_sd: dict, dst_sd: dict) -> dict:
    """``dst_sd`` (a new dict) with every conv weight and bias of ``src_sd``,
    the conv layers paired in forward order; counts and shapes must match."""
    src, dst = conv_entries(src_sd), conv_entries(dst_sd)
    param_keys(src_sd), param_keys(dst_sd)
    if len(src) != len(dst):
        raise ValueError(f"conv count mismatch: the source has {len(src)}, the target "
                         f"{len(dst)} — wrong --gen_net/--num_classes?")
    out = dict(dst_sd)
    for (sw, sb), (dw, db) in zip(src, dst):
        if tuple(src_sd[sw].shape) != tuple(dst_sd[dw].shape) or (sb is None) != (db is None):
            raise ValueError(f"{sw} {tuple(src_sd[sw].shape)} does not fit {dw} "
                             f"{tuple(dst_sd[dw].shape)} (bias {sb is not None} / "
                             f"{db is not None}) — wrong --ngf/--ndf?")
        out[dw] = src_sd[sw].detach().clone()
        if db is not None:
            out[db] = src_sd[sb].detach().clone()
    return out


def import_adam_moments(src_opt_sd: dict, src_sds: list, dst_sds: list,
                        dst_opt_sd: dict) -> tuple[dict, int]:
    """An ``optim.Adam`` state dict over the parameters of the nets
    ``dst_sds`` (in order; each net's :func:`param_keys`) holding the
    per-parameter state of ``src_opt_sd`` over ``src_sds``, paired in the
    same order, every moment shape-checked; with ``dst_opt_sd``'s
    ``param_groups``. Returns it and the largest ``step`` (0 when no
    parameter has state)."""
    src = [sd[k] for sd in src_sds for k in param_keys(sd)]
    dst = [sd[k] for sd in dst_sds for k in param_keys(sd)]
    if len(src) != len(dst):
        raise ValueError(f"optimizer over {len(src)} parameters, the target has {len(dst)}")
    state, step = {}, 0
    for i, target in enumerate(dst):
        st = src_opt_sd["state"].get(i)
        if st is None:
            continue
        new = {}
        for field, v in st.items():
            if field == "step":
                v = v if isinstance(v, torch.Tensor) else torch.tensor(float(v))
                step = max(step, int(v))
            elif tuple(v.shape) != tuple(target.shape):
                raise ValueError(f"Adam state {i} {field} {tuple(v.shape)} does not fit "
                                 f"the parameter {tuple(target.shape)}")
            new[field] = v.detach().clone()
        state[i] = new
    groups = [dict(g) for g in dst_opt_sd["param_groups"]]
    return {"state": state, "param_groups": groups}, step


def set_lr_epoch(opt: torch.optim.Optimizer, sched, cfg: Config, step: int,
                 epoch: int) -> None:
    """The port's LambdaLR after ``step`` updates, with the learning rate
    of ``epoch`` (its staircase's value where ``step`` is that epoch's
    first update)."""
    factor = schedule.lambda_lr_factor(epoch, epochs=cfg.epochs, offset=0,
                                       decay_epoch=cfg.decay_epoch)
    for group, base in zip(opt.param_groups, sched.base_lrs):
        group["lr"] = base * factor
    sched.last_epoch = step
    sched._step_count = step + 1
    sched._last_lr = [g["lr"] for g in opt.param_groups]


def import_checkpoint(ckpt: dict, cfg: Config, num_classes: int, in_channels: int, *,
                      supervised: bool = False, epoch: int | None = None,
                      device: str = "cuda", say=print) -> tuple[dict, int]:
    """A reference checkpoint dict -> (the port's state payload, its epoch):
    the nets loaded into a trainer of ``cfg`` on ``device``, the Adam
    moments mapped (fresh where the checkpoint has none), ``step`` the
    Adams' step, the LambdaLRs at the epoch after the stored one."""
    make = SupervisedTrainer if supervised else CycleGANTrainer
    trainer = make(cfg, num_classes, in_channels, steps_per_epoch=1, device=device)
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    epoch = int(ckpt.get("epoch", 0)) if epoch is None else int(epoch)
    if supervised:
        nets = {"model": find(ckpt, SUPERVISED_KEYS, "segmentation net")}
        opts = {"opt": (state.opt, state.sched, find(ckpt, SUPERVISED_OPT_KEYS, "", False),
                        ["model"])}
    else:
        nets = {n: find(ckpt, keys, n) for n, keys in NET_KEYS.items()}
        opts = {o: (getattr(state, o), getattr(state, o.replace("opt", "sched")),
                    find(ckpt, keys, "", False), names)
                for (o, keys), names in zip(OPT_KEYS.items(), (["G_i2l", "G_l2i"],
                                                               ["D_img", "D_lab"]))}
    modules = {n: getattr(trainer, n) for n in nets}
    for n, sd in nets.items():
        modules[n].load_state_dict(import_net(sd, modules[n].state_dict()))
    step = 0
    for name, (opt, sched, opt_sd, owners) in opts.items():
        if opt_sd is None:
            say(f"no optimizer state for {name} in the checkpoint; moments re-initialized")
            continue
        new, s = import_adam_moments(opt_sd, [nets[n] for n in owners],
                                     [modules[n].state_dict() for n in owners],
                                     opt.state_dict())
        opt.load_state_dict(new)
        step = max(step, s)
        say(f"imported the optimizer moments of {name} (step {s})")
    state.step = step
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for opt, sched, _, _ in opts.values():
            set_lr_epoch(opt, sched, cfg, step, epoch + 1)
    return state_payload(trainer, state), epoch


def config_parser(description: str) -> argparse.ArgumentParser:
    """The tools' flags: ``--preset``, ``--model``, ``--num_classes``,
    ``--in_channels`` and every ``Config`` field, as on the port's CLI."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--preset", default=None)
    p.add_argument("--model", choices=["supervised", "semisupervised"],
                   default="semisupervised",
                   help="semisupervised: 4 nets + 2 Adam states; supervised: the "
                        "segmentation net + its Adam state")
    p.add_argument("--num_classes", type=int, default=None,
                   help="default: the dataset's class count")
    p.add_argument("--in_channels", type=int, default=None)
    for name, arg_type in config_flag_types().items():
        if arg_type is bool:
            p.add_argument(f"--{name}", type=lambda s: s.lower() in ("1", "true"),
                           default=None)
        else:
            p.add_argument(f"--{name}", type=arg_type, default=None)
    return p


def config_of(args: argparse.Namespace) -> tuple[Config, int, int]:
    """(Config, num_classes, in_channels) of the tools' flags; float32."""
    cfg = build_config(args).replace(bf16=False)
    spec_classes, spec_channels, _ = DATASET_SPECS[cfg.dataset]
    return cfg, args.num_classes or spec_classes, args.in_channels or spec_channels


def main(argv=None) -> None:
    p = config_parser(__doc__.splitlines()[0])
    p.add_argument("torch_ckpt")
    p.add_argument("out_dir")
    p.add_argument("--epoch", type=int, default=None,
                   help="override the epoch stored in the checkpoint")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the device the run resumes on (default the card)")
    args = p.parse_args(argv)
    cfg, num_classes, in_channels = config_of(args)
    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    supervised = args.model == "supervised"
    payload, epoch = import_checkpoint(ckpt, cfg, num_classes, in_channels,
                                       supervised=supervised, epoch=args.epoch,
                                       device=args.device)
    CheckpointManager(args.out_dir).save(epoch, payload)
    print(f"imported -> {args.out_dir}/{epoch}.pt ({args.model}, epoch {epoch}, step "
          f"{payload['step']}; --training resumes at epoch {epoch + 1})")


if __name__ == "__main__":
    main()
