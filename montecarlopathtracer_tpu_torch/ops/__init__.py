"""Tensor ops and kernels: random streams, intersection, sampling,
Morton orders, the whole-segment kernel, the segment from known winners,
its vjp, the row scatter, the traversal walk, the split path's
intersectors, and their build."""
