"""Runnable end-to-end examples of the port."""
