"""Model zoo: the ResNet and U-Net generators and the discriminators."""

from cyclegan_tpu_torch.models.discriminators import (  # noqa: F401
    NLayerDiscriminator, PixelDiscriminator, define_Dis)
from cyclegan_tpu_torch.models.generators import (  # noqa: F401
    ResnetGenerator, UnetGenerator, define_Gen)
