"""Configuration and the inference chain of the port."""

from .config import TrainConfig
from .infer import make_infer_fn, preprocess_with_mask

__all__ = ["TrainConfig", "make_infer_fn", "preprocess_with_mask"]
