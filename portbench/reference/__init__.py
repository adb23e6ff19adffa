"""The plain reference of the benchmark's cells, in float32 PyTorch.

It follows the published architecture and the reference training recipe
(arXiv:1908.11569; CycleGAN, arXiv:1703.10593) with ``torch.nn.functional``
calls only: the generators by family (``gen_resnet.py``: CycleGAN's ResNet;
``gen_unet.py``: pix2pix's U-Net, arXiv:1611.07004), the 70x70 PatchGANs,
instance norm, the four losses, the replay pools, Adam with the LambdaLR
staircase, and the served path (50%-overlap tiling, flip and scale
averaging, resize, argmax).
It imports nothing of ``cyclegan_tpu_torch`` and nothing of JAX, and takes
nothing the program made: the benchmark hands it the seeded weights and
inputs, and it draws the dropout masks itself from the seed by a frozen
copy of the draw rule. TF32 is off while it runs (:func:`precise`).
"""

import contextlib

import torch


@contextlib.contextmanager
def precise():
    """TF32 off for matmuls and cuDNN convolutions while the block runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
