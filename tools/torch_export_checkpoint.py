"""Export the port's checkpoint to a reference ``latest.ckpt``.

The counterpart of ``tools/export_torch_checkpoint.py`` for
``cyclegan_tpu_torch``, in torch alone (no JAX), and the inverse of
``tools/torch_import_checkpoint.py``: a run trained on the card goes back
to a PyTorch fleet of the reference, or round-trips for A/B comparisons.
The output is one ``latest.ckpt`` dict (SURVEY.md §3e): the epoch, the four
nets' state dicts keyed Gsi/Gis/Di/Ds (the names the importer reads) in
the layout of ``tools/torch_reference.py``'s nets, and two Adam state
dicts (``g_optimizer``, ``d_optimizer``) carrying the port's moments and
step, so the reference resumes training, not only inference.

Usage:
  python tools/torch_export_checkpoint.py ./checkpoints latest.ckpt \\
      --preset voc_semisup_256 [--gen_net resnet_9blocks --ngf 64 ...] \\
      [--model supervised]

It reads the newest epoch checkpoint under the directory (its key is the
epoch); every ``Config`` field is a flag, as on the port's CLI (the nets'
shapes). The mapping pairs conv layers in forward order on both sides
(``torch_import_checkpoint.import_net``), with the same limit as the JAX
package's tool: instance-norm models only.
"""

from __future__ import annotations

import itertools
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cyclegan_tpu_torch.models.generators import UNET_DOWNS  # noqa: E402
from cyclegan_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from cyclegan_tpu_torch.utils.config import Config  # noqa: E402
from tools.torch_import_checkpoint import (config_of, config_parser,  # noqa: E402
                                           import_adam_moments, import_net)
from tools.torch_reference import PatchD, PixelD, ResnetG, UnetG  # noqa: E402


def export_net(port_sd: dict, ref_sd: dict) -> dict:
    """``ref_sd`` (a new dict) with the port net's conv weights and biases,
    paired in forward order, every shape checked."""
    return import_net(port_sd, ref_sd)


def export_adam_moments(port_opt_sd: dict, port_sds: list, ref_sds: list,
                        ref_opt_sd: dict) -> dict:
    """A reference ``optim.Adam`` state dict (``ref_opt_sd``'s param groups)
    holding the port's moments and step, each parameter's state at its
    place in the reference's ``chain(netA, netB).parameters()`` order."""
    return import_adam_moments(port_opt_sd, port_sds, ref_sds, ref_opt_sd)[0]


def reference_generator(cfg: Config, in_ch: int, out_ch: int, tanh: bool) -> torch.nn.Module:
    if cfg.gen_net in UNET_DOWNS:
        return UnetG(in_ch, out_ch, UNET_DOWNS[cfg.gen_net], cfg.ngf, tanh=tanh)
    if cfg.gen_net.startswith("resnet_") and cfg.gen_net.endswith("blocks"):
        return ResnetG(in_ch, out_ch, cfg.ngf, int(cfg.gen_net[7:-6]), tanh=tanh)
    raise ValueError(f"no reference net for gen_net {cfg.gen_net!r}")


def reference_discriminator(cfg: Config, in_ch: int) -> torch.nn.Module:
    if cfg.dis_net == "pixel":
        return PixelD(in_ch, cfg.ndf)
    return PatchD(in_ch, cfg.ndf, 3 if cfg.dis_net == "basic" else cfg.n_layers_D)


def _adam(*nets: torch.nn.Module) -> torch.optim.Adam:
    return torch.optim.Adam(itertools.chain(*(n.parameters() for n in nets)), lr=2e-4,
                            betas=(0.5, 0.999))


def export_checkpoint(payload: dict, out_path: str, cfg: Config, *, num_classes: int,
                      in_channels: int, epoch: int = 0) -> None:
    """A port state payload (``train/checkpoint.py::state_payload``) of a
    CycleGAN run -> the reference's ``latest.ckpt`` (``torch.save``)."""
    nets = payload["nets"]
    ref = {"Gsi": reference_generator(cfg, in_channels, num_classes, tanh=False),
           "Gis": reference_generator(cfg, num_classes, in_channels, tanh=True),
           "Di": reference_discriminator(cfg, in_channels),
           "Ds": reference_discriminator(cfg, num_classes)}
    ckpt = {name: export_net(nets[port], ref[name].state_dict())
            for name, port in zip(ref, ("G_i2l", "G_l2i", "D_img", "D_lab"))}
    ckpt["epoch"] = epoch
    for key, opt, port, names in (("g_optimizer", "g_opt", ("G_i2l", "G_l2i"), ("Gsi", "Gis")),
                                  ("d_optimizer", "d_opt", ("D_img", "D_lab"), ("Di", "Ds"))):
        ckpt[key] = export_adam_moments(payload[opt], [nets[n] for n in port],
                                        [ckpt[n] for n in names],
                                        _adam(*(ref[n] for n in names)).state_dict())
    torch.save(ckpt, out_path)


def export_supervised_checkpoint(payload: dict, out_path: str, cfg: Config, *,
                                 num_classes: int, in_channels: int, epoch: int = 0) -> None:
    """A supervised run's payload -> a one-net checkpoint (``Gsi``, the
    segmentation net with a raw-logits head; ``g_optimizer``, its Adam),
    which the importer's ``--model supervised`` reads back."""
    net = reference_generator(cfg, in_channels, num_classes, tanh=False)
    sd = export_net(payload["nets"]["model"], net.state_dict())
    torch.save({"epoch": epoch, "Gsi": sd,
                "g_optimizer": export_adam_moments(payload["opt"], [payload["nets"]["model"]],
                                                   [sd], _adam(net).state_dict())}, out_path)


def main(argv=None) -> None:
    p = config_parser(__doc__.splitlines()[0])
    p.add_argument("checkpoint_dir")
    p.add_argument("out_ckpt")
    args = p.parse_args(argv)
    cfg, num_classes, in_channels = config_of(args)
    mngr = CheckpointManager(args.checkpoint_dir)
    epoch = mngr.latest_epoch()
    if epoch is None:
        raise FileNotFoundError(f"no epoch checkpoint in {args.checkpoint_dir}")
    payload, _ = mngr.restore(epoch=epoch)
    kw = dict(num_classes=num_classes, in_channels=in_channels, epoch=epoch)
    if args.model == "supervised":
        export_supervised_checkpoint(payload, args.out_ckpt, cfg, **kw)
        print(f"exported -> {args.out_ckpt} (reference format, 1 net + 1 Adam state, "
              f"epoch {epoch})")
    else:
        export_checkpoint(payload, args.out_ckpt, cfg, **kw)
        print(f"exported -> {args.out_ckpt} (reference latest.ckpt format, 4 nets + 2 Adam "
              f"states, epoch {epoch})")


if __name__ == "__main__":
    main()
