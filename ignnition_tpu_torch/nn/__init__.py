"""Layers, feed-forward networks and recurrent cells of the port."""

from . import layers, mlp, rnn

__all__ = ["layers", "mlp", "rnn"]
