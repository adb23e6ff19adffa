"""Functional primitives, initialisation and op blocks (NCHW modules over
channels_last memory)."""
