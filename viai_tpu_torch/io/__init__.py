"""Checkpoint bridge from the JAX package's `.pth` files."""

from .checkpoint import (generator_state_from_flat, load_generator_pth,
                         load_networks, load_video_pth, state_from_flat,
                         video_state_from_flat)

__all__ = ["generator_state_from_flat", "load_generator_pth", "load_networks",
           "video_state_from_flat", "load_video_pth", "state_from_flat"]
