"""The reference of the served class maps: tiling, flip and scale averaging.

For one canvas image (H, W, C) the served logits are, in float32:

- scales (outermost): for each scale s the canvas is resized to (round(H s
  / 4) * 4, round(W s / 4) * 4) (at least 4), the logits below are taken
  there and resized back to (H, W), and the scales' logits are averaged;
- flip: 0.5 * (f(x) + mirror(f(mirror(x)))), mirrors along W;
- tiles (innermost): the window slides over the canvas with a stride of
  half the window (rounded), the last window pinned to the edge, and each
  pixel averages the logits of the windows that cover it.

The class map is the argmax over classes. Resize (frozen copy of the rule
of ``jax.image.resize(..., "linear")``): output pixel i of n samples the
input of m pixels at ``(i + 0.5) m / n - 0.5`` with a triangle filter of
half-width ``max(m / n, 1)`` (antialiased when it shrinks), its weights
normalised over the pixels inside the input.
"""

from __future__ import annotations

import torch

from portbench.reference import nets
from portbench.reference.precision import EXACT


def resize_matrix(n_out: int, n_in: int, device) -> torch.Tensor:
    """(n_out, n_in) float64 weights of the linear resize along one axis."""
    scale = n_in / n_out
    width = max(scale, 1.0)
    centre = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * scale
    src = torch.arange(n_in, dtype=torch.float64, device=device) + 0.5
    w = (1.0 - (src[None, :] - centre[:, None]).abs() / width).clamp_min(0.0)
    return w / w.sum(dim=1, keepdim=True)


def resize(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(N, H, W, C) -> (N, h, w, C) float32 by :func:`resize_matrix`."""
    _, h_in, w_in, _ = x.shape
    mh = resize_matrix(hw[0], h_in, x.device).float()
    mw = resize_matrix(hw[1], w_in, x.device).float()
    return torch.einsum("ih,nhwc,jw->nijc", mh, x.float(), mw)


def positions(size: int, win: int, stride: int) -> list[int]:
    if size <= win:
        return [0]
    pos = list(range(0, size - win + 1, stride))
    if pos[-1] != size - win:
        pos.append(size - win)
    return pos


def snapped(h: int, w: int, s: float, snap: int = 4) -> tuple[int, int]:
    return (max(int(round(h * s / snap)) * snap, snap),
            max(int(round(w * s / snap)) * snap, snap))


class ReferenceServer:
    """G_i2l's float32 parameters, its configuration (the generator's family
    and sizes) and the serving options; :meth:`logits` gives an image's
    served logits. Windows go through the net ``chunk`` at a time."""

    def __init__(self, params: dict, cfg: dict, window: tuple[int, int], *, flip: bool,
                 scales: tuple[float, ...], q=EXACT, chunk: int = 16):
        self.p = {k: v.float() for k, v in params.items()}
        self.cfg, self.gen = cfg, nets.family(cfg["gen_net"])
        self.window, self.flip, self.scales = window, flip, scales
        self.q, self.chunk = q, chunk

    def _net(self, wins: torch.Tensor) -> torch.Tensor:
        outs = [self.gen.forward(self.p, c.permute(0, 3, 1, 2), self.cfg, False, self.q)
                for c in wins.split(self.chunk)]
        return torch.cat(outs).permute(0, 2, 3, 1)

    def _tiled(self, img: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = img.shape
        ch, cw = self.window
        ys = positions(h, ch, max(int(round(ch * 0.5)), 1))
        xs = positions(w, cw, max(int(round(cw * 0.5)), 1))
        logits = self._net(torch.cat([img[:, y:y + ch, x:x + cw] for y in ys for x in xs]))
        acc = torch.zeros((1, h, w, logits.shape[-1]), device=img.device)
        cnt = torch.zeros((h, w, 1), device=img.device)
        for i, (y, x) in enumerate((y, x) for y in ys for x in xs):
            acc[:, y:y + ch, x:x + cw] += logits[i:i + 1]
            cnt[y:y + ch, x:x + cw] += 1.0
        return acc / cnt

    def _flipped(self, img: torch.Tensor) -> torch.Tensor:
        straight = self._tiled(img)
        if not self.flip:
            return straight
        return 0.5 * (straight + self._tiled(img.flip(2)).flip(2))

    @torch.no_grad()
    def logits(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, C) canvas -> (H, W, K) float32 served logits."""
        img = image.float()[None]
        h, w = img.shape[1:3]
        acc = None
        for s in self.scales:
            hs, ws = snapped(h, w, s)
            if (hs, ws) == (h, w):
                lo = self._flipped(img)
            else:
                lo = resize(self._flipped(resize(img, (hs, ws))), (h, w))
            acc = lo if acc is None else acc + lo
        return (acc / len(self.scales))[0]


def served_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """The widest gap by which the reference's logit of a served class lies
    below the reference's best logit at that pixel."""
    pick = ref_logits.gather(-1, served.long().unsqueeze(-1)).squeeze(-1)
    return float((ref_logits.max(dim=-1).values - pick).max())
