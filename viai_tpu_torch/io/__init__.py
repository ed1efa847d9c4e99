"""Checkpoints: the JAX package's `.pth` schema both ways, and the
port's full train state."""

from .checkpoint import (available_epochs, flat_from_state,
                         generator_state_from_flat, load_generator_pth,
                         load_networks, load_train_state, load_video_pth,
                         save_networks, save_train_state, state_from_flat,
                         video_state_from_flat)

__all__ = ["generator_state_from_flat", "load_generator_pth", "load_networks",
           "video_state_from_flat", "load_video_pth", "state_from_flat",
           "flat_from_state", "save_networks", "available_epochs",
           "save_train_state", "load_train_state"]
