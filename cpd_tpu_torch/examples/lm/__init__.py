"""Transformer-LM trainer of the port."""
