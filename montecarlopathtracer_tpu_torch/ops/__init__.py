"""Tensor ops and kernels: random streams, intersection, sampling,
the whole-segment kernel, its vjp and the row scatter, and their build."""
