"""Recurrence ops with hand-written CUDA kernels."""
