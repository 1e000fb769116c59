"""Segment primitives and the hand-written CUDA kernels behind them."""

from . import segment

__all__ = ["segment"]
