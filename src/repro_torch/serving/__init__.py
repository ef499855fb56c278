"""Serving-time weight packing."""
