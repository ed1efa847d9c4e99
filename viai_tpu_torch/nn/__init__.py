"""Networks of the port."""

from .factory import define_G
from .generator import (BatchNorm, DownBlock, GeneratorConfig, InstanceNorm,
                        UNetGenerator, UpBlock)
from .initializers import INIT_TYPES, kernel_init_for

__all__ = [
    "define_G", "GeneratorConfig", "UNetGenerator", "DownBlock", "UpBlock",
    "InstanceNorm", "BatchNorm", "INIT_TYPES", "kernel_init_for",
]
