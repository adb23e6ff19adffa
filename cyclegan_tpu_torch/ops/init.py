"""Weight initialisation with the reference's ``init_weights`` semantics.

Counterpart of ``cyclegan_tpu/ops/init.py``: conv and transposed-conv
weights from N(0, 0.02), biases zero. Draws come from an explicit
``torch.Generator`` so a seed fixes the weights; they are not the JAX
package's numbers for the same seed (the two generators differ), so tests
carry weights across with ``cyclegan_tpu_torch.weights`` instead.
"""

from __future__ import annotations

import torch
from torch import nn

from cyclegan_tpu_torch.ops.blocks import BatchNorm


@torch.no_grad()
def conv_kernel_init_(w: torch.Tensor, generator: torch.Generator | None = None,
                      std: float = 0.02) -> torch.Tensor:
    """Fill ``w`` in place from N(0, ``std``). The draws are made on the
    generator's device, so a CPU generator gives the same weights to a
    module on the CPU and on the card."""
    if generator is None or generator.device.type == w.device.type:
        return w.normal_(0.0, std, generator=generator)
    draws = torch.empty(w.shape, dtype=w.dtype, device=generator.device)
    return w.copy_(draws.normal_(0.0, std, generator=generator))


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator | None = None,
                 std: float = 0.02) -> nn.Module:
    """N(0, std) for every conv / transposed-conv weight, zeros for biases,
    in registration order (one generator makes the result reproducible);
    batch norms back to their initial values (Flax's: scale 1, bias 0,
    running mean 0 and variance 1)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            conv_kernel_init_(m.weight, generator, std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.reset()
    return module
