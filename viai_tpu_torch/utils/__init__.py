"""Utilities of the port: loss logs (and TensorBoard event files),
result galleries, profiling, the build cache and counts of work."""

from .profiling import StepTimer, disable_debug_mode, enable_debug_mode, trace
from .visualizer import HTMLGallery, Visualizer, spec_to_png, write_wav

__all__ = ["Visualizer", "HTMLGallery", "spec_to_png", "write_wav",
           "StepTimer", "trace", "enable_debug_mode", "disable_debug_mode"]
