"""CLI of the port (counterpart of ``cyclegan_tpu/main.py``): train, test,
export and serve on the GPU.

Every ``Config`` field is a flag of the same name (``config_flag_types``);
``--preset`` starts from one of the presets. The device is the CUDA card
unless ``--device cpu`` (or the JAX flag's spelling, ``--platform cpu``)
asks for the CPU, where the kernels' plain versions run.

Usage:
  python -m cyclegan_tpu_torch.main --training --preset voc_semisup_256 \
      --data_root /data/VOC2012
  python -m cyclegan_tpu_torch.main --training --dataset synthetic --epochs 2
  python -m cyclegan_tpu_torch.main --training --model supervised \
      --preset voc_supervised_128 --data_root /data/VOC2012
  python -m cyclegan_tpu_torch.main --testing --model supervised \
      --preset voc_supervised_128 --eval_resize tile --resize_height 192 \
      --resize_width 192 --eval_flip true --eval_scales 0.75,1.0,1.25
  python -m cyclegan_tpu_torch.main --testing --dataset synthetic
  # artifact of the newest checkpoint under --checkpoint_dir (the run's flags)
  python -m cyclegan_tpu_torch.main --export model --preset voc_semisup_256 \
      --checkpoint_dir ./checkpoints [--export_what segment|logits|generate] \
      [--export_quantize int8|bf16] [--export_input uint8]
  # ... or from a Flax G_i2l param tree saved as a '/'-keyed .npz
  python -m cyclegan_tpu_torch.main --export model --weights_npz g_i2l.npz
  python -m cyclegan_tpu_torch.main --serve model.pt --serve_input imgs/ \
      --serve_output preds/ [--serve_gt masks/]
  # tiled canvas + flip + multi-scale TTA (a logits artifact), every card
  python -m cyclegan_tpu_torch.main --serve logits.pt --serve_input imgs/ \
      --serve_canvas_height 512 --serve_canvas_width 512 --serve_flip \
      --serve_scales 0.75,1.0,1.25 [--serve_dp]
  python -m cyclegan_tpu_torch.main --serve model.pt --serve_http 8000
  # data parallel: one rank a device, the global batch split over them
  python -m cyclegan_tpu_torch.main --training --num_devices 4 --batch_size 8
  python -m cyclegan_tpu_torch.main --training --device cpu --num_devices 2 \
      --dataset synthetic --batch_size 2           # two gloo ranks on the CPU
  torchrun --nproc_per_node 8 -m cyclegan_tpu_torch.main --training \
      --preset voc_dp8_bf16 --data_root /data/VOC2012
  # spatial axis: each image's H split over 2 ranks (2 data rows x 2 slabs)
  python -m cyclegan_tpu_torch.main --training --preset cityscapes_semisup_512x256 \
      --num_devices 4 --spatial_shards 2 --batch_size 2 --data_root /data/cityscapes

``--num_devices k`` (``--gpu_ids 0,1,..`` names k devices) is the GLOBAL
device count, as in the JAX CLI: one launch starts k ranks, one a visible
CUDA device (gloo ranks with ``--device cpu``); None means every visible
CUDA device, and 1 on the CPU. With ``--coordinator_address`` each of
``--num_processes`` processes starts ``num_devices / num_processes`` ranks,
of global rank ``process_id * local + i``; under torchrun each process is
one rank. ``--spatial_shards s`` makes them k / s data rows of s ranks that
each hold an H slab of the row's images (``crop_height`` a multiple of
4 s).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
import types
import typing

from cyclegan_tpu_torch.parallel import distributed
from cyclegan_tpu_torch.utils.config import Config, preset


def get_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="cyclegan_tpu_torch: semi-supervised CycleGAN segmentation on a GPU")
    p.add_argument("--training", action="store_true")
    p.add_argument("--testing", action="store_true")
    p.add_argument("--model", choices=["supervised", "semisupervised"],
                   default="semisupervised")
    p.add_argument("--preset", type=str, default=None,
                   help="one of the presets (utils.config.PRESETS)")
    p.add_argument("--max_steps", type=int, default=None,
                   help="stop after N optimizer steps; a cut epoch is saved as a "
                        "mid-epoch checkpoint")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--platform", choices=["cuda", "gpu", "cpu"], default=None,
                   help="the JAX CLI's flag: an alias of --device (gpu = cuda)")
    p.add_argument("--export", type=str, default=None, metavar="PATH",
                   help="write the artifact PATH.pt + PATH.json of the newest "
                        "checkpoint under --checkpoint_dir")
    p.add_argument("--export_what", choices=["segment", "logits", "generate"],
                   default="segment",
                   help="generate = the label->image generator (semi-supervised "
                        "checkpoints)")
    p.add_argument("--export_quantize", choices=["int8", "bf16"], default=None,
                   help="weight-only quantisation of the artifact: int8 per output "
                        "channel (~4x smaller) or bf16 (~2x)")
    p.add_argument("--export_input", choices=["float32", "uint8"], default="float32",
                   help="uint8 = the artifact takes raw shaped pixels and "
                        "normalizes them on the device")
    p.add_argument("--weights_npz", type=str, default=None, metavar="PATH",
                   help="export a Flax G_i2l param tree with '/'-joined keys "
                        "(params/... and batch_stats/... under --norm batch) "
                        "instead of a checkpoint")
    p.add_argument("--num_classes", type=int, default=None,
                   help="of the --export generator (default: the dataset's)")
    p.add_argument("--in_channels", type=int, default=None,
                   help="of the --export generator (default: the dataset's)")
    p.add_argument("--serve", type=str, default=None, metavar="ARTIFACT",
                   help="serve an exported artifact (PATH or PATH.pt)")
    p.add_argument("--serve_input", type=str, default=None, metavar="DIR")
    p.add_argument("--serve_output", type=str, default="./results", metavar="DIR")
    p.add_argument("--serve_gt", type=str, default=None, metavar="DIR",
                   help="ground-truth masks with the images' stems (.png): "
                        "enables scoring")
    p.add_argument("--serve_batch", type=int, default=8)
    p.add_argument("--serve_canvas_height", type=int, default=None,
                   help="tiled serving: load images at this canvas and slide the "
                        "artifact's window over it, averaging logits (a logits "
                        "artifact; pass both canvas flags)")
    p.add_argument("--serve_canvas_width", type=int, default=None)
    p.add_argument("--serve_flip", action="store_true",
                   help="horizontal-flip TTA (a logits artifact; or --eval_flip true)")
    p.add_argument("--serve_scales", type=str, default=None,
                   help="multi-scale TTA, e.g. 0.75,1.0,1.25 (needs the canvas "
                        "flags; or --eval_scales)")
    p.add_argument("--serve_dp", action="store_true",
                   help="split each batch over every visible CUDA device")
    p.add_argument("--serve_http", type=int, default=None, metavar="PORT")
    p.add_argument("--serve_host", type=str, default="127.0.0.1")
    p.add_argument("--serve_http_batch", type=int, default=8,
                   help="micro-batching cap of the HTTP endpoint")
    p.add_argument("--gpu_ids", type=str, default=None,
                   help="the reference's flag: '0,1,2' selects 3 devices (an alias of "
                        "--num_devices)")
    for name, arg_type in config_flag_types().items():
        if name == "bf16":
            p.add_argument("--no_bf16", dest="bf16", action="store_false", default=None,
                           help="compute in float32 instead of bf16")
        elif arg_type is bool:
            p.add_argument(f"--{name}", type=lambda s: s.lower() in ("1", "true"),
                           default=None)
        else:
            p.add_argument(f"--{name}", type=arg_type, default=None)
    args = p.parse_args(argv)
    if args.platform is not None:
        args.device = "cpu" if args.platform == "cpu" else "cuda"
    return args


def config_flag_types() -> dict[str, type]:
    """Config field -> argparse type, from the dataclass annotations
    (``X | None`` unwraps to ``X``); an unsupported annotation raises."""
    hints = typing.get_type_hints(Config)
    out: dict[str, type] = {}
    for f in dataclasses.fields(Config):
        t = hints[f.name]
        if typing.get_origin(t) in (typing.Union, types.UnionType):
            non_none = [a for a in typing.get_args(t) if a is not type(None)]
            if len(non_none) != 1:
                raise TypeError(f"Config.{f.name}: can't synthesize a CLI flag for union "
                                f"annotation {t!r}")
            t = non_none[0]
        if t not in (int, float, str, bool):
            raise TypeError(f"Config.{f.name}: can't synthesize a CLI flag for annotation "
                            f"{t!r} (supported: int, float, str, bool and their Optionals)")
        out[f.name] = t
    return out


def build_config(args: argparse.Namespace) -> Config:
    cfg = preset(args.preset) if args.preset else Config()
    overrides = {f.name: getattr(args, f.name) for f in dataclasses.fields(Config)
                 if getattr(args, f.name, None) is not None}
    if getattr(args, "gpu_ids", None) and "num_devices" not in overrides:
        overrides["num_devices"] = len([g for g in args.gpu_ids.split(",") if g.strip()])
    return cfg.replace(**overrides)


def _local_ranks(cfg: Config, device: str) -> tuple[int, int, int]:
    """(ranks this launch starts, world, first rank) of a --training or
    --testing run; (1, world, rank) where this process is one rank itself
    (torchrun, or a coordinator with one device a process)."""
    import torch

    if distributed.distributed_launch_pending(cfg, os.environ) \
            and not cfg.coordinator_address:
        return 1, int(os.environ.get("WORLD_SIZE", "1")), int(os.environ.get("RANK", "0"))
    visible = torch.cuda.device_count() if device == "cuda" else 1
    world = cfg.num_devices or max(visible, 1)
    nproc = max(int(cfg.num_processes or 1), 1) if cfg.coordinator_address else 1
    if world % nproc:
        raise ValueError(f"num_devices {world} does not divide over {nproc} processes")
    local = world // nproc
    if device == "cuda" and local > max(visible, 1):
        raise ValueError(f"{local} ranks a process need {local} CUDA devices; "
                         f"{visible} visible")
    return local, world, int(cfg.process_id or 0) * local


def _run(args: argparse.Namespace, cfg: Config):
    from cyclegan_tpu_torch.train import runner

    semisup = args.model == "semisupervised"
    if args.testing:
        return runner.run_test(cfg, semisupervised=semisup, device=args.device)
    if not semisup:
        return runner.run_supervised(cfg, max_steps=args.max_steps, device=args.device)
    return runner.run_cyclegan(cfg, max_steps=args.max_steps, device=args.device)


def _launch(args: argparse.Namespace, cfg: Config):
    """Run --training / --testing, in this process or in the ranks of a
    data-parallel launch (what rank 0 returns)."""
    from cyclegan_tpu_torch.train import runner

    runner.check_mesh_config(cfg)  # refuse before any rank starts
    local, world, first = _local_ranks(cfg, args.device)
    if local == 1:
        return _run(args, cfg)
    cfg = cfg.replace(num_devices=world)
    if cfg.coordinator_address:
        return distributed.launch_local(_run, (args, cfg), nprocs=local, world=world,
                                        first_rank=first, device=args.device,
                                        init_method=f"tcp://{cfg.coordinator_address}")
    store = tempfile.mkdtemp(prefix="cgtpu_dist_")
    try:
        return distributed.launch_local(_run, (args, cfg), nprocs=local, world=world,
                                        device=args.device,
                                        init_method=f"file://{os.path.join(store, 'store')}")
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _export(args, cfg: Config) -> str:
    from cyclegan_tpu_torch.export import run_export

    return run_export(cfg, args.export, semisupervised=args.model == "semisupervised",
                      what=args.export_what, quantize=args.export_quantize,
                      input_dtype=args.export_input, device=args.device,
                      num_classes=args.num_classes, in_channels=args.in_channels,
                      weights_npz=args.weights_npz)


def _serve(args, cfg: Config):
    from cyclegan_tpu_torch.tta import parse_scales

    canvas = None
    if args.serve_canvas_height or args.serve_canvas_width:
        if not (args.serve_canvas_height and args.serve_canvas_width):
            raise SystemExit("pass BOTH --serve_canvas_height and --serve_canvas_width")
        canvas = (args.serve_canvas_height, args.serve_canvas_width)
    # A training config with eval_resize=tile maps to canvas serving; the
    # image-load convention on the canvas is a plain resize.
    resize = "resize" if (cfg.eval_resize == "tile" and canvas) else cfg.eval_resize
    opts = dict(eval_resize=resize, canvas_hw=canvas, data_parallel=args.serve_dp,
                flip=args.serve_flip or cfg.eval_flip,
                scales=parse_scales(args.serve_scales or cfg.eval_scales), device=args.device)
    if args.serve_http is not None:
        from cyclegan_tpu_torch.http_serve import run_http_serve

        return run_http_serve(args.serve, host=args.serve_host, port=args.serve_http,
                              max_batch=args.serve_http_batch, **opts)
    if not args.serve_input:
        raise SystemExit("--serve needs --serve_input DIR (or --serve_http PORT)")
    from cyclegan_tpu_torch.serve import run_serve

    return run_serve(args.serve, args.serve_input, args.serve_output,
                     batch_size=args.serve_batch, gt_dir=args.serve_gt, **opts)


def main(argv=None):
    """Run the CLI; returns what the run returned (the runner's scores for
    --training and --testing)."""
    args = get_args(argv)
    cfg = build_config(args)
    if args.serve:
        return _serve(args, cfg)
    if args.export:
        return _export(args, cfg)
    if args.testing or args.training:
        return _launch(args, cfg)
    raise SystemExit("pass --training, --testing, --export PATH or --serve ARTIFACT")


if __name__ == "__main__":
    main()
