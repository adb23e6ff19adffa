"""What a cell's run is fed, made from ``--seed``: weights, batches, images.

Everything is drawn on the run's device from one ``torch.Generator`` seeded
with the seed, in a few large calls and in a fixed order, so that one seed
gives one set of inputs; the host draws (pool decisions, which answers are
checked) come from ``numpy.random.default_rng(seed)``. The program and the
reference get the same tensors: the reference rebuilds them from the seed
after the window.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import nets

WEIGHT_STD = 0.02  # N(0, 0.02) convolution weights, zero biases (reference init)
VOID = 255


def net_specs(cfg: dict) -> dict:
    """{net: [(name, shape)]} of the four networks of a configuration."""
    gen = nets.family(cfg["gen_net"])
    k, c = cfg["num_classes"], cfg["in_channels"]
    return {"G_i2l": gen.spec(c, k, cfg),
            "G_l2i": gen.spec(k, c, cfg),
            "D_img": nets.patchgan_spec(c, cfg["ndf"], cfg["n_layers_D"]),
            "D_lab": nets.patchgan_spec(k, cfg["ndf"], cfg["n_layers_D"])}


def make_weights(cfg: dict, gen: torch.Generator, nets_wanted=("G_i2l", "G_l2i", "D_img",
                                                                "D_lab")) -> dict:
    """{net: {name: float32 tensor}}: one normal draw a network for all its
    convolution weights, biases zero. Networks are drawn in the fixed order
    of :func:`net_specs`; those not wanted are drawn and dropped, so a
    network's weights do not depend on which others a cell uses."""
    out = {}
    dev = gen.device
    for net, spec in net_specs(cfg).items():
        wsizes = [int(np.prod(s)) for name, s in spec if name.endswith("weight")]
        flat = torch.randn(sum(wsizes), generator=gen, device=dev) * WEIGHT_STD
        if net not in nets_wanted:
            continue
        params, at = {}, 0
        for name, shape in spec:
            if name.endswith("weight"):
                size = int(np.prod(shape))
                params[name] = flat[at:at + size].view(shape)
                at += size
            else:
                params[name] = torch.zeros(shape, device=dev)
        out[net] = params
    return out


def load_into(module: torch.nn.Module, weights: dict, what: str) -> None:
    """Copy ``weights`` into ``module``'s parameters; every parameter of the
    module, and no other, with its shape, or this raises."""
    own = dict(module.named_parameters())
    if set(own) != set(weights) or any(own[k].shape != weights[k].shape for k in own):
        raise RuntimeError(f"{what}: the program's parameters "
                           f"{sorted((k, tuple(v.shape)) for k, v in own.items())[:4]}... do "
                           f"not match the benchmark's architecture")
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(weights[k])


def make_batches(cfg: dict, params: dict, gen: torch.Generator) -> list[dict]:
    """A ring of ``params['ring']`` distinct batches of ``cfg['batch_size']``
    rows: lab_image, unlab_image (B, H, W, C) float32 in [-1, 1), smooth
    (a random image at 1/``image_cell`` of the size, bilinear up, plus
    noise); lab_label (B, H, W) int64, classes constant on squares of
    ``label_cell`` pixels, with a void border of ``void_border`` pixels, as
    VOC's masks have."""
    n, b = params["ring"], cfg["batch_size"]
    h, w, c = cfg["crop_height"], cfg["crop_width"], cfg["in_channels"]
    dev = gen.device
    imgs = []
    for _ in range(2):
        cell = params["image_cell"]
        coarse = torch.rand((n * b, c, h // cell, w // cell), generator=gen, device=dev)
        up = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                             align_corners=False)
        noise = torch.rand((n * b, c, h, w), generator=gen, device=dev)
        img = (0.8 * up + 0.2 * noise) * 2 - 1
        imgs.append(img.permute(0, 2, 3, 1).contiguous().view(n, b, h, w, c))
    cell = params["label_cell"]
    lab = torch.randint(0, cfg["num_classes"], (n * b, h // cell, w // cell), generator=gen,
                        device=dev)
    lab = lab.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    v = params["void_border"]
    lab[:, :v], lab[:, -v:], lab[:, :, :v], lab[:, :, -v:] = VOID, VOID, VOID, VOID
    lab = lab.view(n, b, h, w)
    return [{"lab_image": imgs[0][i], "unlab_image": imgs[1][i], "lab_label": lab[i]}
            for i in range(n)]


def make_pools(cfg: dict, params: dict, gen: torch.Generator) -> tuple:
    """The replay pools' contents before the first step, full: (image pool
    (P, H, W, C) in [-1, 1), smooth as the batches; label pool (P, H, W, K),
    a softmax of random logits a pixel), P = ``pool_size``, rounded to the
    compute type the pools store (bf16 under ``cfg['bf16']``), so that both
    sides start from the same values."""
    n, (h, w) = max(cfg["pool_size"], 1), (cfg["crop_height"], cfg["crop_width"])
    c, k, cell = cfg["in_channels"], cfg["num_classes"], params["image_cell"]
    dev = gen.device
    coarse = torch.rand((n, c, h // cell, w // cell), generator=gen, device=dev)
    up = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                         align_corners=False)
    noise = torch.rand((n, c, h, w), generator=gen, device=dev)
    img = ((0.8 * up + 0.2 * noise) * 2 - 1).permute(0, 2, 3, 1)
    logits = torch.randn((n, h // cell, w // cell, k), generator=gen, device=dev) * 3
    lab = torch.softmax(logits, -1).repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    store = torch.bfloat16 if cfg["bf16"] else torch.float32
    return tuple(x.to(store).float().contiguous() for x in (img, lab))


def pool_decisions(cfg: dict, ring: int, rng: np.random.Generator) -> list[dict]:
    """Per ring slot and row: keep the new fake (p = 0.5) or swap it with a
    uniform slot, for the image pool and the label pool (numpy, host)."""
    b, size = cfg["batch_size"], max(cfg["pool_size"], 1)
    keep = rng.random((ring, 2, b)) > 0.5
    slot = rng.integers(0, size, (ring, 2, b))
    return [{"pool_use_new_img": keep[i, 0], "pool_idx_img": slot[i, 0],
             "pool_use_new_lab": keep[i, 1], "pool_idx_lab": slot[i, 1]} for i in range(ring)]


def make_images(params: dict, c: int, gen: torch.Generator) -> torch.Tensor:
    """(ring, H, W, C) float32 canvases in [-1, 1), smooth as the batches."""
    n, (h, w) = params["ring"], params["canvas_hw"]
    cell = params["image_cell"]
    dev = gen.device
    coarse = torch.rand((n, c, h // cell, w // cell), generator=gen, device=dev)
    up = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                         align_corners=False)
    noise = torch.rand((n, c, h, w), generator=gen, device=dev)
    return ((0.8 * up + 0.2 * noise) * 2 - 1).permute(0, 2, 3, 1).contiguous()
