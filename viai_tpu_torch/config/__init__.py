"""Command-line options of the port."""

from .options import BaseOptions, TrainOptions, device_from_opt

__all__ = ["BaseOptions", "TrainOptions", "device_from_opt"]
