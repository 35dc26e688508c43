"""Ops of the port: padding, resize, convs and the hand-written kernels."""
