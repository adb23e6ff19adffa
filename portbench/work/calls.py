"""The work the port's kernels are needed for, by C entry, from shapes.

For each C entry of the port (the names its launch counter
``cyclegan_tpu_torch.kernels._build.launches`` counts) this gives the calls
that the model's function needs of it in one unit of work, and the least
time their work could take on the H100's peaks
(:func:`portbench.work.peaks.least_seconds`). What the function needs, at
the configuration's types (bf16 operands and activations, float32 weight
gradients and norm statistics), each input read once and each output
written once:

- a ResNet residual block's forward: 2 convolutions
  (``cg_conv3x3_reflect``), the first instance norm (+ ReLU) and the
  second (+ the block's skip);
- its backward: 2 input gradients (``cg_conv3x3_reflect_dgrad``), 2 weight
  gradients (``cg_conv_dw``) and 2 norm VJPs;
- every other instance norm (the ResNet's stem, down1, down2, up1, up2;
  the U-Net's; the PatchGAN's three): one forward, and one VJP where a
  backward runs.

A generator's calls come from its family's ``calls``
(``reference/gen_<family>.py``); the PatchGAN's are here.

Nothing else is needed work: a forward recomputed inside a backward, a
product split into several bf16 passes, the buffers of that split
(``cg_bf16_parts``), padding and layout passes. Their time is in the
kernels' device time and shows as headroom in the roofline share. The
count does not depend on the trunk route: a route that takes a function
to the library launches no call of its entry, and
:func:`portbench.readings.roofline` credits an entry no more calls than it
launched.
"""

from __future__ import annotations

import collections

from portbench.work import model
from portbench.work.peaks import least_seconds

CONV_ENTRIES = ("cg_conv3x3_reflect", "cg_conv3x3_reflect_dgrad", "cg_conv_dw")
NORM_ENTRIES = ("cg_instance_norm_act", "cg_instance_norm_act_bwd")
# The device functions that the C entries above launch, by family.
CONV_KERNELS = ("conv3x3_wgmma", "conv3x3_reflect_f32", "dgrad_mma", "fold_pad1", "wgrad_wgmma",
                "dw_reduce", "bf16_parts")
NORM_KERNELS = ("in_fwd", "in_bwd")
IN_FLOPS = 8  # float32 operations an element, statistics and normalisation
BF16 = 2


class Calls:
    """{entry: [calls, least seconds]} of one unit of work."""

    def __init__(self):
        self.by_entry = collections.defaultdict(lambda: [0, 0.0])

    def add(self, entry: str, flops: float, nbytes: float, dtype: str = "bfloat16") -> None:
        rec = self.by_entry[entry]
        rec[0] += 1
        rec[1] += least_seconds(flops, nbytes, dtype)

    def norm(self, entry: str, elems: int, tensors: int) -> None:
        """A norm pass reading and writing ``tensors`` bf16 tensors in all."""
        self.add(entry, IN_FLOPS * elems, elems * tensors * BF16, "float32")


def _generator(c: Calls, cfg: dict, rows: int, backward: bool) -> None:
    """The calls of one generator apply, by its family
    (``reference/gen_<family>.py``)."""
    from portbench.reference.nets import family

    family(cfg["gen_net"]).calls(c, cfg, rows, backward)


def _patchgan(c: Calls, cfg: dict, rows: int) -> None:
    ndf, h = cfg["ndf"], cfg["crop_height"]
    w = cfg["crop_width"]
    chans = [min(ndf * 2 ** i, ndf * 8) for i in range(cfg["n_layers_D"] + 1)]
    strides = [2] * cfg["n_layers_D"] + [1]
    for k, s in enumerate(strides):
        h, w = model.conv_out(h, 4, s, 1), model.conv_out(w, 4, s, 1)
        if k == 0:
            continue  # the first layer has no norm
        e = rows * chans[k] * h * w
        c.norm("cg_instance_norm_act", e, 2)
        c.norm("cg_instance_norm_act_bwd", e, 3)


def train_step_calls(cfg: dict) -> dict:
    """{entry: [calls, least seconds]} that one train step needs: three
    generator applies with their backward ([unlab; lab] and [onehot;
    fake_lab] of 2B rows, fake_img of B), four PatchGAN applies with theirs
    (B, B, 2B, 2B)."""
    c, b = Calls(), cfg["batch_size"]
    for rows in (2 * b, 2 * b, b):
        _generator(c, cfg, rows, backward=True)
    for rows in (b, b, 2 * b, 2 * b):
        _patchgan(c, cfg, rows)
    return dict(c.by_entry)


def serve_batch_calls(cfg: dict, params: dict) -> dict:
    """{entry: [calls, least seconds]} that one served batch needs: a
    forward of G_i2l on every window stack."""
    c = Calls()
    for rows in model.serve_forwards(cfg, params):
        _generator(c, cfg, rows, backward=False)
    return dict(c.by_entry)
