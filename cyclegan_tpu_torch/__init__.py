"""PyTorch / CUDA port of cyclegan_tpu for one NVIDIA H100 (Hopper, sm_90a).

Module names mirror ``cyclegan_tpu`` so each counterpart is easy to find.
This package imports torch and never jax, flax, optax, orbax or
``cyclegan_tpu`` itself; the JAX package is the reference the tests hold it
against. Ported so far, the serving path of the image->label generator
and the semi-supervised CycleGAN train step:

- ``ops`` (functional ops, init, blocks), ``models.generators`` (ResNet
  generator) and ``models.discriminators`` (PatchGAN, PixelGAN);
- ``kernels``: hand-written CUDA kernels for every TPU kernel of the JAX
  package (``instance_norm_act``, ``residual_block_fused`` and
  ``residual_block_chunked``, forward and VJP, as
  ``torch.autograd.Function``s, and ``conv_dw``, the weight gradient of
  ``ops.functional.conv2d_valid_dw_fused``), each beside its plain PyTorch
  version;
- ``train`` (``cyclegan.CycleGANTrainer``, losses, LR schedule, replay
  pool, metrics) and ``utils.config`` (``Config`` and the presets);
- ``weights`` (Flax param trees -> modules), ``export`` (the port's
  artifact), ``serve`` / ``http_serve`` (directory and HTTP serving) and
  ``main`` (the CLI);
- ``parallel`` (data parallelism on ``torch.distributed``: one rank a
  device, the step that of the global batch).

Entry points run on the CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
