"""Model FLOPs from shapes: what the forward and backward passes require.

A convolution of one row costs 2 * (output pixels) * Cin * Cout * k * k
FLOPs forward (a transposed one: input pixels instead of output pixels).
Its backward needs the input gradient (the same count) only where
something upstream wants a gradient, and the weight gradient (the same
count) only where its parameters train in that pass. Nothing recomputed
is counted, and nothing but the convolutions (norms, activations, losses
and the optimizer are a fraction of a percent of the step).
"""

from __future__ import annotations


def conv_out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def patchgan_macs(in_nc: int, ndf: int, n_layers: int, h: int, w: int) -> list:
    chans = [in_nc] + [min(ndf * 2 ** i, ndf * 8) for i in range(n_layers + 1)] + [1]
    strides = [2] * n_layers + [1, 1]
    out = []
    for k, s in enumerate(strides):
        h, w = conv_out(h, 4, s, 1), conv_out(w, 4, s, 1)
        out.append(h * w * chans[k] * chans[k + 1] * 16)
    return out


def pass_flops(macs: list, rows: int, *, input_grad: bool, weight_grad: bool,
               backward: bool = True) -> float:
    """FLOPs of ``rows`` rows through layers of ``macs``: forward, plus the
    input gradients every layer but the first needs (the first's too when
    ``input_grad``), plus the weight gradients when ``weight_grad``."""
    fwd = sum(macs)
    if not backward:
        return 2.0 * rows * fwd
    dgrad = fwd if input_grad else fwd - macs[0]
    return 2.0 * rows * (fwd + dgrad + (fwd if weight_grad else 0))


def nets_macs(cfg: dict) -> dict:
    """{net: forward multiply-adds of one row, layer by layer}; the
    generators' from their family (``reference/gen_<family>.py``)."""
    from portbench.reference.nets import family

    gen = family(cfg["gen_net"])
    k, c, h, w = cfg["num_classes"], cfg["in_channels"], cfg["crop_height"], cfg["crop_width"]
    return {"G_i2l": gen.macs(c, k, cfg, h, w),
            "G_l2i": gen.macs(k, c, cfg, h, w),
            "D_img": patchgan_macs(c, cfg["ndf"], cfg["n_layers_D"], h, w),
            "D_lab": patchgan_macs(k, cfg["ndf"], cfg["n_layers_D"], h, w)}


def train_step_flops(cfg: dict) -> float:
    """Model FLOPs of one train step of ``cfg['batch_size']`` rows (the
    passes of ``reference/train.py``)."""
    m, b = nets_macs(cfg), cfg["batch_size"]
    g = [  # G phase: the generators train, the discriminators pass gradients
        pass_flops(m["G_i2l"], 2 * b, input_grad=False, weight_grad=True),   # [unlab; lab]
        pass_flops(m["G_l2i"], b, input_grad=False, weight_grad=True),       # onehot rows
        pass_flops(m["G_l2i"], b, input_grad=True, weight_grad=True),        # fake_lab rows
        pass_flops(m["G_i2l"], b, input_grad=True, weight_grad=True),        # fake_img
        pass_flops(m["D_lab"], b, input_grad=True, weight_grad=False),
        pass_flops(m["D_img"], b, input_grad=True, weight_grad=False)]
    d = [pass_flops(m["D_img"], 2 * b, input_grad=False, weight_grad=True),  # D phase
         pass_flops(m["D_lab"], 2 * b, input_grad=False, weight_grad=True)]
    return sum(g) + sum(d)


def window_counts(canvas_hw, window_hw, scales) -> list:
    """Windows a canvas image makes at each scale (50% overlap, the last
    pinned to the edge, dims snapped to multiples of 4)."""
    from portbench.reference.serve import positions, snapped

    (h, w), (ch, cw) = canvas_hw, window_hw
    out = []
    for s in scales:
        hs, ws = snapped(h, w, s)
        out.append(len(positions(hs, ch, max(round(ch * 0.5), 1)))
                   * len(positions(ws, cw, max(round(cw * 0.5), 1))))
    return out


def serve_forwards(cfg: dict, params: dict) -> list:
    """Rows of each G_i2l call of one served batch (a scale's window stack,
    and again mirrored under flip)."""
    wins = window_counts(params["canvas_hw"], (cfg["crop_height"], cfg["crop_width"]),
                         params["scales"])
    reps = 2 if params["flip"] else 1
    return [n * params["images_per_call"] for n in wins for _ in range(reps)]


def serve_batch_flops(cfg: dict, params: dict) -> float:
    """Model FLOPs of one served batch: G_i2l forward on every window."""
    g = nets_macs(cfg)["G_i2l"]
    return sum(pass_flops(g, rows, input_grad=False, weight_grad=False, backward=False)
               for rows in serve_forwards(cfg, params))
