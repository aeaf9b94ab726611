"""Transformer examples."""
