"""PyTorch / CUDA port of cyclegan_tpu for one NVIDIA H100 (Hopper, sm_90a).

Module names mirror ``cyclegan_tpu`` so each counterpart is easy to find.
This package imports torch and never jax, flax, optax, orbax or
``cyclegan_tpu`` itself; the JAX package is the reference the tests hold it
against. What is ported so far is the serving path of the image->label
generator:

- ``ops`` (functional ops, init, blocks) and ``models.generators``
  (ResNet generator);
- ``kernels``: hand-written CUDA kernels for the two TPU kernels on that
  path (``instance_norm_act``, ``residual_block_fused``), each beside its
  plain PyTorch version;
- ``weights`` (Flax param tree -> module), ``export`` (the port's artifact),
  ``serve`` / ``http_serve`` (directory and HTTP serving) and ``main``
  (the serving CLI).

Entry points run on the CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
