"""Serving CLI of the port (counterpart of ``cyclegan_tpu/main.py``'s
``--export`` and ``--serve`` dispatch; training arrives with its slice).

Usage:
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

import torch


def get_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="cyclegan_tpu_torch: serve the segmentation generator on a GPU")
    p.add_argument("--export", type=str, default=None, metavar="PATH",
                   help="write the artifact PATH.pt + PATH.json")
    p.add_argument("--export_what", choices=["segment", "logits"], default="segment")
    p.add_argument("--export_input", choices=["float32", "uint8"], default="float32",
                   help="uint8 = the artifact takes raw shaped pixels and "
                        "normalizes them on the device")
    p.add_argument("--weights_npz", type=str, default=None, metavar="PATH",
                   help="Flax G_i2l param tree with '/'-joined keys; without it "
                        "--export draws N(0, 0.02) weights from --seed")
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
    p.add_argument("--eval_resize", choices=["resize", "center_crop"], default="resize")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    # Generator configuration for --export (the JAX Config's names).
    p.add_argument("--dataset", type=str, default="voc2012",
                   help="names the classes in the manifest")
    p.add_argument("--gen_net", type=str, default="resnet_9blocks")
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--num_classes", type=int, default=21)
    p.add_argument("--in_channels", type=int, default=3)
    p.add_argument("--crop_height", type=int, default=256)
    p.add_argument("--crop_width", type=int, default=256)
    p.add_argument("--no_bf16", dest="bf16", action="store_false",
                   help="compute in float32 instead of bf16")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def _export(args) -> None:
    from cyclegan_tpu_torch.export import export_generator
    from cyclegan_tpu_torch.models.generators import define_Gen
    from cyclegan_tpu_torch.weights import load_flax_module, load_npz

    G = define_Gen(args.in_channels, args.num_classes, args.ngf, args.gen_net,
                   head="none", generator=torch.Generator().manual_seed(args.seed))
    if args.weights_npz:
        load_flax_module(G, load_npz(args.weights_npz))
    path = export_generator(
        G, args.export, gen_net=args.gen_net, ngf=args.ngf,
        num_classes=args.num_classes, in_channels=args.in_channels,
        crop_hw=(args.crop_height, args.crop_width),
        dtype="bfloat16" if args.bf16 else "float32", head=args.export_what,
        input_dtype=args.export_input, dataset=args.dataset)
    src = args.weights_npz or f"random N(0, 0.02) weights, seed {args.seed}"
    print(f"exported {args.export_what} head ({src}) -> {path}", flush=True)


def main(argv=None) -> None:
    args = get_args(argv)
    if args.serve:
        if args.serve_http is not None:
            from cyclegan_tpu_torch.http_serve import run_http_serve

            run_http_serve(args.serve, host=args.serve_host, port=args.serve_http,
                           eval_resize=args.eval_resize, max_batch=args.serve_http_batch,
                           device=args.device)
            return
        if not args.serve_input:
            raise SystemExit("--serve needs --serve_input DIR (or --serve_http PORT)")
        from cyclegan_tpu_torch.serve import run_serve

        run_serve(args.serve, args.serve_input, args.serve_output,
                  batch_size=args.serve_batch, gt_dir=args.serve_gt,
                  eval_resize=args.eval_resize, device=args.device)
    elif args.export:
        _export(args)
    else:
        raise SystemExit("pass --export PATH or --serve ARTIFACT")


if __name__ == "__main__":
    main()
