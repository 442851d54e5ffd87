"""Orchestration layer: pipeline, downloader, validator, visualizer, auditor.

This package's own copy of the JAX package's ``pipeline/``, on the port's
engine; the blueprint is drawn and read without PIL (``png.py``,
``raster.py``).
"""

from .pipeline import VideoPipeline

__all__ = ["VideoPipeline"]
