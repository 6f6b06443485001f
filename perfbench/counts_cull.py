"""The work of a pass of the culled regen pass B1rc, whatever implements
it: the yardstick of its roofline.

- Operations: as :mod:`.counts` counts them for B1r, the triangles
  whose bounding box each ray segment of the pass enters before its hit,
  at :data:`.counts.OPS_PER_TEST` a test, from the plain reference on a
  seeded sample of pixels: any triangle-granular method (culling by
  chunks included) has to test those.
- Bytes: the culled table's inputs read once and the outputs written
  once: the row table f32[T, 48], the chunk boxes f32[nc, 3] twice and
  their slack f32[nc, 2] (chunks of :data:`CHUNK` triangles), the
  records f32[T + ceil(T / LEAF), 16] (a row a triangle, then a box a
  leaf of :data:`LEAF`), the key table, the camera and the arguments in;
  the accumulation f32[3, R] and the lane steps i32[R] out.
"""

from __future__ import annotations

from . import counts
from .counts import F32, OPS_PER_TEST

CHUNK = 128  # triangles a chunk box covers, in the culled table's Morton order
LEAF = 16  # triangles a leaf box of the records covers
KERNEL = "regen_pass_kernel<true>"


def table_bytes(T: int) -> int:
    """The culled table's bytes over T triangles: rows, chunk boxes and
    slack, records."""
    nc, leaves = -(-T // CHUNK), -(-T // LEAF)
    return T * 48 * F32 + nc * (3 + 3 + 2) * F32 + (T + leaves) * 16 * F32


def work(ctx, est) -> dict:
    """The pass's work for B1rc: ``{"B1rc": {"kernel": its name in the
    trace, "ops", "bytes"}}`` a pass."""
    tr = ctx.traffic
    if not (tr["chunk_cull"] and tr["regen"]):
        raise ValueError("the count covers the culled regen pass B1rc only")
    R_, spp = ctx.width * ctx.height, int(tr["spp_per_pass"])
    T = ctx.scene_arrays().num_triangles
    tested, n = counts.reach(ctx, est, 1, spp, int(tr["reach_pixels"]))
    ops = OPS_PER_TEST * sum(tested.values()) * R_ / n
    keys = est.max_steps(spp) * 5 * 2 * 4
    nbytes = table_bytes(T) + keys + 14 * F32 + R_ * (3 * F32 + 4) + 10 * 8
    return {"B1rc": {"kernel": KERNEL, "ops": ops, "bytes": nbytes}}
