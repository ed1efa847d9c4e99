"""Checkpoint bridge from the JAX package's `.pth` files."""

from .checkpoint import (generator_state_from_flat, load_generator_pth,
                         load_networks)

__all__ = ["generator_state_from_flat", "load_generator_pth", "load_networks"]
