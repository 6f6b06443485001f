"""Tensor ops and kernels: random streams, intersection, sampling,
Morton orders, the whole-segment kernel, the segment from known winners,
its vjp, the row scatter, the traversal walk, the split path's
intersectors and the superseded selection entries over them, the
selection microkernels, the KD-tree walk, and their build."""
