"""Networks of the port."""

from .factory import define_G, define_V
from .generator import (AttentionBlock, BatchNorm, ChannelLayerNorm,
                        DilatedTimeBlock, DownBlock, GeneratorConfig,
                        GroupNorm, InstanceNorm, UNetGenerator, UpBlock,
                        sincos_pos_embed)
from .initializers import INIT_TYPES, kernel_init_for
from .video import (VideoFeatureNet, VideoNetConfig, linear_resize_weights,
                    resize_time)

__all__ = [
    "define_G", "define_V", "GeneratorConfig", "UNetGenerator", "DownBlock",
    "UpBlock", "DilatedTimeBlock", "AttentionBlock", "ChannelLayerNorm",
    "sincos_pos_embed", "InstanceNorm", "BatchNorm", "GroupNorm",
    "VideoNetConfig", "VideoFeatureNet", "linear_resize_weights",
    "resize_time", "INIT_TYPES", "kernel_init_for",
]
