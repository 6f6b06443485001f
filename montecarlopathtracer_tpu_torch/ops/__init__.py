"""Tensor ops and kernels: random streams, intersection, sampling,
the whole-segment kernel and its build."""
