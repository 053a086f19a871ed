"""Geometry, image, loss and warp ops, and the photometric kernel binding.

Public functions keep the JAX package's NHWC layout, so that the tests
compare like with like."""
