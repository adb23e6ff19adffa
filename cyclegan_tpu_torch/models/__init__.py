"""Model zoo (the ResNet generators so far)."""

from cyclegan_tpu_torch.models.generators import ResnetGenerator, define_Gen  # noqa: F401
