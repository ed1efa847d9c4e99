"""Command-line options of the port."""

from .options import BaseOptions, TestOptions, TrainOptions, device_from_opt

__all__ = ["BaseOptions", "TrainOptions", "TestOptions", "device_from_opt"]
