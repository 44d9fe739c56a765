"""Attention, rope and sampling ops, and the CUDA kernel wrappers."""
