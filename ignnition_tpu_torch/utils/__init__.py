"""Utilities: the normalization registry."""

from .registry import get_normalization, normalizations, register_normalization

__all__ = ["get_normalization", "normalizations", "register_normalization"]
