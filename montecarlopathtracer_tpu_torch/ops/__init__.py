"""Tensor ops and kernels: random streams, intersection, sampling,
Morton orders, the whole-segment kernel, the segment from known winners,
its vjp, the row scatter and the traversal walk, and their build."""
