"""Tensor ops of the port: layers, losses, initializers and the row gather."""
