"""Hand-written Hopper kernels (``csrc/*.cu``), each with its plain PyTorch
version beside it and a launch counter on its wrapper."""

from cyclegan_tpu_torch.kernels.instance_norm import (  # noqa: F401
    instance_norm_act, instance_norm_act_plain)
from cyclegan_tpu_torch.kernels.resblock import (  # noqa: F401
    residual_block_fused, residual_block_plain)
