"""Utilities of the port: loss logs and result galleries."""

from .visualizer import HTMLGallery, Visualizer, spec_to_png, write_wav

__all__ = ["Visualizer", "HTMLGallery", "spec_to_png", "write_wav"]
