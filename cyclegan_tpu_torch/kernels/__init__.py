"""Hand-written Hopper kernels (``csrc/*.cu``), each with its plain PyTorch
version beside it; ``_build.launches`` counts the calls of every C entry,
the port's one launch counter. The wrappers are
``torch.autograd.Function``s whose backward is a kernel too (the kernel of
``kernels.conv_dw`` is itself a backward: ``ops.functional.
conv2d_valid_dw_fused`` is its Function). ``kernels.conv_dw`` stays the
module here: its function has the module's name."""

from cyclegan_tpu_torch.kernels import conv_dw  # noqa: F401
from cyclegan_tpu_torch.kernels.instance_norm import (  # noqa: F401
    instance_norm_act, instance_norm_act_bwd_plain, instance_norm_act_plain,
    instance_norm_act_reference)
from cyclegan_tpu_torch.kernels.resblock import (  # noqa: F401
    residual_block_bwd_saved_plain, residual_block_fused, residual_block_plain,
    residual_block_reference)
from cyclegan_tpu_torch.kernels.resblock_chunked import (  # noqa: F401
    residual_block_chunked, residual_block_chunked_bwd_plain, residual_block_chunked_fwd,
    residual_block_chunked_plain, residual_block_chunked_reference)
