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
  python -m cyclegan_tpu_torch.main --testing --dataset synthetic
  # artifact from a Flax G_i2l param tree saved as a '/'-keyed .npz
  python -m cyclegan_tpu_torch.main --export model --weights_npz g_i2l.npz
  # ... or from random N(0, 0.02) weights drawn from --seed (smoke runs)
  python -m cyclegan_tpu_torch.main --export model
  python -m cyclegan_tpu_torch.main --serve model.pt --serve_input imgs/ \
      --serve_output preds/ [--serve_gt masks/]
  python -m cyclegan_tpu_torch.main --serve model.pt --serve_http 8000
"""

from __future__ import annotations

import argparse
import dataclasses
import types
import typing

import torch

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
                   help="write the artifact PATH.pt + PATH.json")
    p.add_argument("--export_what", choices=["segment", "logits"], default="segment")
    p.add_argument("--export_input", choices=["float32", "uint8"], default="float32",
                   help="uint8 = the artifact takes raw shaped pixels and "
                        "normalizes them on the device")
    p.add_argument("--weights_npz", type=str, default=None, metavar="PATH",
                   help="Flax G_i2l param tree with '/'-joined keys; without it "
                        "--export draws N(0, 0.02) weights from --seed")
    p.add_argument("--num_classes", type=int, default=21, help="of the --export generator")
    p.add_argument("--in_channels", type=int, default=3, help="of the --export generator")
    p.add_argument("--serve", type=str, default=None, metavar="ARTIFACT",
                   help="serve an exported artifact (PATH or PATH.pt)")
    p.add_argument("--serve_input", type=str, default=None, metavar="DIR")
    p.add_argument("--serve_output", type=str, default="./results", metavar="DIR")
    p.add_argument("--serve_gt", type=str, default=None, metavar="DIR",
                   help="ground-truth masks with the images' stems (.png): "
                        "enables scoring")
    p.add_argument("--serve_batch", type=int, default=8)
    p.add_argument("--serve_http", type=int, default=None, metavar="PORT")
    p.add_argument("--serve_host", type=str, default="127.0.0.1")
    p.add_argument("--serve_http_batch", type=int, default=8,
                   help="micro-batching cap of the HTTP endpoint")
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
    return cfg.replace(**{f.name: getattr(args, f.name) for f in dataclasses.fields(Config)
                          if getattr(args, f.name, None) is not None})


def _export(args, cfg: Config) -> None:
    from cyclegan_tpu_torch.export import export_generator
    from cyclegan_tpu_torch.models.generators import define_Gen
    from cyclegan_tpu_torch.weights import load_flax_module, load_npz

    G = define_Gen(args.in_channels, args.num_classes, cfg.ngf, cfg.gen_net,
                   head="none", generator=torch.Generator().manual_seed(cfg.seed))
    if args.weights_npz:
        load_flax_module(G, load_npz(args.weights_npz))
    path = export_generator(
        G, args.export, gen_net=cfg.gen_net, ngf=cfg.ngf, num_classes=args.num_classes,
        in_channels=args.in_channels, crop_hw=cfg.crop_hw,
        dtype="bfloat16" if cfg.bf16 else "float32", head=args.export_what,
        input_dtype=args.export_input, dataset=cfg.dataset)
    src = args.weights_npz or f"random N(0, 0.02) weights, seed {cfg.seed}"
    print(f"exported {args.export_what} head ({src}) -> {path}", flush=True)


def main(argv=None):
    """Run the CLI; returns what the run returned (the runner's scores for
    --training and --testing)."""
    args = get_args(argv)
    cfg = build_config(args)
    if args.serve:
        if args.serve_http is not None:
            from cyclegan_tpu_torch.http_serve import run_http_serve

            return run_http_serve(args.serve, host=args.serve_host, port=args.serve_http,
                                  eval_resize=cfg.eval_resize,
                                  max_batch=args.serve_http_batch, device=args.device)
        if not args.serve_input:
            raise SystemExit("--serve needs --serve_input DIR (or --serve_http PORT)")
        from cyclegan_tpu_torch.serve import run_serve

        return run_serve(args.serve, args.serve_input, args.serve_output,
                         batch_size=args.serve_batch, gt_dir=args.serve_gt,
                         eval_resize=cfg.eval_resize, device=args.device)
    if args.export:
        return _export(args, cfg)
    from cyclegan_tpu_torch.train import runner

    semisup = args.model == "semisupervised"
    if args.testing:
        return runner.run_test(cfg, semisupervised=semisup, device=args.device)
    if args.training:
        if not semisup:
            return runner.run_supervised(cfg, max_steps=args.max_steps, device=args.device)
        return runner.run_cyclegan(cfg, max_steps=args.max_steps, device=args.device)
    raise SystemExit("pass --training, --testing, --export PATH or --serve ARTIFACT")


if __name__ == "__main__":
    main()
