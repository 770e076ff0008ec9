"""Utilities of the port: the per-stage roofline (``roofline``)."""
