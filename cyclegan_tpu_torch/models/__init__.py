"""Model zoo: the ResNet generators and the discriminators."""

from cyclegan_tpu_torch.models.discriminators import (  # noqa: F401
    NLayerDiscriminator, PixelDiscriminator, define_Dis)
from cyclegan_tpu_torch.models.generators import ResnetGenerator, define_Gen  # noqa: F401
