"""Networks of the port."""

from .discriminator import (DiscriminatorConfig, MultiScaleDiscriminator,
                            PatchDiscriminator, avg_pool_same)
from .factory import define_D, define_G, define_R, define_V
from .generator import (AttentionBlock, BatchNorm, ChannelLayerNorm,
                        DilatedTimeBlock, DownBlock, GeneratorConfig,
                        GroupNorm, InstanceNorm, UNetGenerator, UpBlock,
                        sincos_pos_embed)
from .initializers import INIT_TYPES, kernel_init_for
from .refiner import DiffusionRefiner, RefinerConfig, timestep_embedding
from .video import (VideoFeatureNet, VideoNetConfig, linear_resize_weights,
                    resize_time)

__all__ = [
    "define_G", "define_D", "define_V", "define_R", "RefinerConfig",
    "DiffusionRefiner", "timestep_embedding", "DiscriminatorConfig",
    "PatchDiscriminator", "MultiScaleDiscriminator", "avg_pool_same",
    "GeneratorConfig", "UNetGenerator", "DownBlock", "UpBlock", "DilatedTimeBlock", "AttentionBlock", "ChannelLayerNorm",
    "sincos_pos_embed", "InstanceNorm", "BatchNorm", "GroupNorm",
    "VideoNetConfig", "VideoFeatureNet", "linear_resize_weights",
    "resize_time", "INIT_TYPES", "kernel_init_for",
]
