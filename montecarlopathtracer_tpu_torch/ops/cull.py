"""Chunk culling's tables, its plain per-lane reach, and a plain emulation
of the culled loop's visits.

The culling kernels (B1c in ``csrc/segment_fused.cu``, B4c in
``csrc/nearest_shade.cu``, and the entries B10c and B11 over B4c) take
the triangles in Morton order and skip a 128-triangle chunk whose box a
ray's segment [0, best t] cannot enter. The exact pair test accepts hits
up to its rounding slack outside an ill-conditioned triangle, so the
vertices' box alone is not conservative: each chunk's box is widened,
for a ray with |o| = on, by ext + grow·on, the largest sphere slack
K0 − ρ and growth per unit of |o| of its triangles
(``sphere_select.cuh::triangle_sphere_split``), as the traversal walk's
tree widens its nodes.

- :func:`chunk_slack` builds that widening once per table, in torch ops
  on the table's device;
- :func:`cull_records` builds, once per table, the 64-byte triangle
  records that the culled loop reads (``nearest_shade.cu::
  cull_records_kernel`` for CUDA tensors, :func:`cull_records_ref` for
  CPU ones; it counts its launch as B4r);
- :func:`chunk_entry` and :func:`chunk_reach` are the plain versions of
  the kernels' per-lane test (``nearest_common.cuh::chunk_entry``),
  rounded as the kernels round it;
- :func:`cull_visits` emulates the chunks that the loop visits under
  several rules, from a vote per block of 256 rays down to each lane
  alone, and the kernels' own rule (a vote per warp, nearest chunk
  first, then each lane's own leaf boxes inside a chunk), with its
  winners and its ``tested`` counts.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.profiling import count_launch
from . import cuda_build
from .traverse_walk import CHUNK, sphere_split_ref

_BIG = 3.0e38
WINDOW = 32  # chunks a warp orders at once (sphere_select.cuh's kWindow)
WARP_RAYS = 64  # rays per warp of the culled loop: two per lane
LEAF = 16  # triangles per leaf box of the records (sphere_select.cuh's kLeaf)
_NONE = 0xFFFFFFFF  # the key of a chunk that no ray of the warp reaches


def chunk_slack(rows, chunk: int = CHUNK) -> torch.Tensor:
    """f32[ceil(T / chunk), 2]: per chunk of ``chunk`` consecutive rows of
    ``rows`` f32[T, 48] (or the geometry table f32[T, 12]), ext = the
    largest sphere slack and grow = the largest radius growth per unit of
    |o| of its triangles (:func:`.traverse_walk.sphere_split_ref`). An
    ill-conditioned or non-finite triangle makes ext infinite; a triangle
    whose geometry is zero (padding) can never be accepted (d'_z = 0) and
    widens nothing."""
    _, grow, ext = sphere_split_ref(rows)
    never = (rows[:, :12] == 0).all(dim=1)
    T = rows.shape[0]
    pad = -T % chunk
    cols = [torch.nn.functional.pad(torch.where(never, 0.0, x), (0, pad)).reshape(-1, chunk)
            .amax(dim=1) for x in (ext, grow)]
    return torch.stack(cols, dim=1).contiguous()


def cull_records_ref(rows) -> torch.Tensor:
    """Plain version of :func:`cull_records`: f32[T + ceil(T / 16), 16].
    Row i < T: triangle i of ``rows`` f32[T, 48], its widened sphere's
    center and K0 (:func:`.traverse_walk.sphere_split_ref`; a NaN center x
    for an all-zero geometry row, which no ray then tests exactly), then
    its 12 geometry floats. Row T + l: the box of leaf l (triangles 16 l
    .. 16 l + 15), lo xyz 0 hi xyz 0 and zeros: the least center − K0 and
    the largest center + K0 of its rows, all-zero rows left out (+inf and
    −inf when nothing is left)."""
    T = rows.shape[0]
    sph = sphere_split_ref(rows)[0].clone()
    zero = (rows[:, :12] == 0).all(dim=1)
    ctr, K0 = sph[:, :3], sph[:, 3:]
    pad = -T % LEAF
    lo, hi = (torch.nn.functional.pad(torch.where(zero[:, None], fill, x), (0, 0, 0, pad),
                                      value=fill).reshape(-1, LEAF, 3)
              for x, fill in ((ctr - K0, float("inf")), (ctr + K0, -float("inf"))))
    z = torch.zeros(lo.shape[0], 1, dtype=rows.dtype, device=rows.device)
    leaves = torch.cat([lo.amin(1), z, hi.amax(1), z, torch.zeros(lo.shape[0], 8,
                                                               dtype=rows.dtype,
                                                               device=rows.device)], dim=1)
    sph[:, 0] = torch.where(zero, float("nan"), sph[:, 0])
    return torch.cat([torch.cat([sph, rows[:, :12]], dim=1), leaves]).contiguous()


def records_shape(T: int) -> tuple:
    """The shape of :func:`cull_records` for a T-row table."""
    return (T + -(-T // LEAF), 16)


@functools.cache
def _records_lib() -> ctypes.CDLL:
    lib = cuda_build.load("nearest_shade")
    fn = lib.cull_records_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def cull_records(rows) -> torch.Tensor:
    """The culled loop's records f32[T + ceil(T / 16), 16] of the row
    table ``rows`` f32[T, 48] (contiguous, 16-byte aligned): per triangle
    its sphere's center and K0, then its three geometry rows; then the box
    of each leaf of 16 triangles (:func:`cull_records_ref`). CUDA tensors
    launch ``nearest_shade.cu``'s record kernel and count it as B4r; CPU
    tensors run :func:`cull_records_ref`."""
    if rows.device.type == "cpu":
        return cull_records_ref(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"no record kernel for device {rows.device}")
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != 48 \
            or not rows.is_contiguous() or rows.data_ptr() % 16 or not 0 < rows.shape[0] < 2**31:
        raise ValueError(f"records need a contiguous, aligned float32 [T, 48] table, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    rec = torch.empty(records_shape(rows.shape[0]), device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = _records_lib().cull_records_launch(rows.data_ptr(), rows.shape[0],
                                                 rec.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cull_records kernel launch failed: cudaError {err}")
    count_launch("B4r")
    return rec


def check_records(crec, rows) -> None:
    """The records of ``rows``: contiguous float32 :func:`records_shape` on
    its device."""
    shape = records_shape(rows.shape[0])
    if crec.device != rows.device or crec.dtype != torch.float32 or not crec.is_contiguous() \
            or tuple(crec.shape) != shape or crec.data_ptr() % 16:
        raise ValueError(f"records must be a contiguous float32 {list(shape)} tensor on "
                         f"{rows.device} (ops.cull.cull_records)")


def _norm(o):
    """|o| of ``o`` f32[s, 3] rounded as ``nearest_common.cuh::norm_rn``."""
    return torch.sqrt(o[:, 0] * o[:, 0] + o[:, 1] * o[:, 1] + o[:, 2] * o[:, 2])


def chunk_entry(clo, chi, o, d, slack=None, on=None):
    """(tn f32[s, nc], ok bool[s, nc]): the entry distance of each ray
    ``o``, ``d`` f32[s, 3] into the box of chunk j (``clo``, ``chi``
    f32[nc, 3]) widened as the kernels widen it, the box margin 1e-5·(1 +
    max |coordinate|) plus ext + grow·on with ``slack`` f32[nc, 2]
    (:func:`chunk_slack`) and ``on`` f32[s] (|o| when not given), and
    whether the ray's line meets that box at
    t ≥ 0; the segment [0, t] reaches it iff ok and tn ≤ t. An axis with
    |d| < 1e-12 is tested by containment. In f32, each operation rounded
    as ``nearest_common.cuh::chunk_entry`` rounds it, with ``fmin``/
    ``fmax`` as its ``fminf``/``fmaxf``."""
    m = 1e-5 * (1.0 + torch.fmax(clo.abs(), chi.abs()))[None]  # [1, nc, 3]
    if slack is not None:
        on = _norm(o) if on is None else on
        m = m + (slack[None, :, 1] * on[:, None] + slack[None, :, 0])[..., None]
    lo, hi = clo[None] - m, chi[None] + m
    o, d = o[:, None, :], d[:, None, :]
    flat = d.abs() < 1e-12
    inv = 1.0 / torch.where(flat, 1.0, d)
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    outside = (o < lo) | (o > hi)
    # fmaxf/fminf pass over a NaN distance: it bounds nothing.
    near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
    tn = torch.where(flat, torch.where(outside, _BIG, -_BIG), near.masked_fill(near.isnan(), -_BIG))
    tf = torch.where(flat, torch.where(outside, -_BIG, _BIG), far.masked_fill(far.isnan(), _BIG))
    tn, tf = tn.amax(dim=2).clamp_min(-_BIG), tf.amin(dim=2).clamp_max(_BIG)
    return tn, (tn <= tf) & (tf >= 0.0)


def chunk_reach(clo, chi, o, d, t_best, slack=None) -> torch.Tensor:
    """bool[s, nc]: whether the segment [0, t_best] of each ray ``o``, ``d``
    f32[s, 3] (``t_best`` f32[s]) can enter the box of chunk j widened as
    the kernels widen it (:func:`chunk_entry`)."""
    tn, ok = chunk_entry(clo, chi, o, d, slack)
    return ok & (tn <= t_best[:, None])


def _entry_key(tn):
    """int64 sort keys of entry distances: the order of the f32 values as
    unsigned ints, -0 taken as +0 (``sphere_select.cuh::entry_key``)."""
    u = (tn + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def chunk_winners(rows, pos3, dir3, select=None, chunk: int = CHUNK):
    """(t f32[R, nc], i i64[R, nc]): each ray's nearest accepted triangle
    within each chunk of ``chunk`` rows (t = 3e38 and i = −1 for none),
    by ``select(rows_chunk, pos3, dir3)`` → (t f32[R], local index, −1 or
    anything for a miss): by default the plain f32 selection
    (``segment_fused._select_ref``); on the card, B4 over each chunk gives
    the kernels' own bits."""
    if select is None:
        from .segment_fused import _select_ref

        def select(r, p, d):
            return _select_ref(r, p, d)[:2]

    ts, idx = [], []
    for base in range(0, rows.shape[0], chunk):
        t, i = select(rows[base:base + chunk].contiguous(), pos3, dir3)
        hit = t < _BIG
        ts.append(torch.where(hit, t, _BIG))
        idx.append(torch.where(hit, i.to(torch.int64) + base, -1))
    return torch.stack(ts, dim=1), torch.stack(idx, dim=1)


def leaf_entry(rows, cslack, o, d):
    """(tn f32[s, nl], ok bool[s, nl]): the entry distance of each ray
    ``o``, ``d`` f32[s, 3] into the box of each leaf of :data:`LEAF` rows
    of ``rows`` f32[T, 48] (:func:`cull_records_ref`) widened as the
    kernels widen it (``sphere_select.cuh::leaf_reach``): the box margin
    plus grow·min(|o|, 3e38), grow that of the leaf's chunk in ``cslack``
    f32[nc, 2]; and whether the ray's line meets that box at t ≥ 0 (never
    for a leaf of all-zero rows only). The segment [0, t] reaches the
    leaf iff ok and tn ≤ t."""
    T = rows.shape[0]
    box = cull_records_ref(rows)[T:]
    lo, hi = box[:, :3], box[:, 4:7]
    nl = lo.shape[0]
    grow = torch.zeros(nl, 2, device=rows.device)
    grow[:, 1] = cslack[torch.arange(nl, device=rows.device) // (CHUNK // LEAF), 1]
    on = _norm(o)
    tn, ok = chunk_entry(lo, hi, o, d, grow, on=torch.fmin(on, torch.full_like(on, _BIG)))
    return tn, ok & (lo[:, 0] <= hi[:, 0])[None]


RULES = {
    "a": "vote per block of 256 rays, index order",
    "b": "vote per group of 128 rays, index order",
    "c": "vote per warp (64 rays), index order",
    "d": "vote per warp, nearest chunk first, leaf boxes per lane (the kernels' rule)",
    "e": "each lane alone, index order",
    "f": "each lane alone, nearest chunk first",
    "g": "floor: the chunks each lane reaches at its final t",
}


def cull_visits(rows, clo, chi, cslack, pos3, dir3, live, winners=None) -> dict:
    """The chunks that the culled loop visits on a Morton-ordered table
    ``rows`` f32[T, 48] (chunk boxes ``clo``, ``chi`` f32[nc, 3], slack
    ``cslack`` f32[nc, 2]) for the rays ``pos3``, ``dir3`` f32[3, R] and
    ``live`` bool[R], under each rule of :data:`RULES`. A lane tests a
    chunk when its own segment [0, best t] reaches the chunk's box; a
    vote makes the whole unit (block, group, warp) pay for the chunk.
    Warps hold 64 consecutive rays and groups 128, as the kernels place
    them; (d) orders the chunks of each window of 32 by the least entry
    distance of the warp's rays that reach them at the window's start, as
    the kernels do, and a hit out of index order wins on the least (t,
    index) pair; inside a chunk that its warp visits, a lane tests a leaf
    of :data:`LEAF` triangles, in index order, only if its segment [0,
    best t] reaches the leaf's box (:func:`cull_records_ref`) widened by
    the box margin and grow·min(|o|, 3e38), grow the chunk's
    (``sphere_select.cuh::test_chunk``). ``winners`` = :func:`chunk_winners`
    of the table with ``chunk`` = :data:`LEAF`, each leaf's own winners
    (computed here when not given).

    Returns ``mean``: {rule: chunks tested per live ray}; ``leaves``: the
    leaves each live ray tested under (d), on average; ``tested``
    i64[ceil(R / 128)]: per group of 128 rays the chunks that either of its
    warps tested under (d), the kernels' ``tested``; ``idx`` i64[R] and
    ``t`` f32[R]: the winners under (d)."""
    R, nc, dev = pos3.shape[1], clo.shape[0], pos3.device
    Rp = -(-R // 256) * 256
    pad = Rp - R
    o = torch.nn.functional.pad(pos3, (0, pad)).T
    d = torch.nn.functional.pad(dir3, (0, pad), value=1.0).T
    alive = torch.nn.functional.pad(live.to(torch.bool), (0, pad))
    tl, il = chunk_winners(rows, pos3, dir3, chunk=LEAF) if winners is None else winners
    tl = torch.nn.functional.pad(tl, (0, 0, 0, pad), value=_BIG)
    il = torch.nn.functional.pad(il, (0, 0, 0, pad), value=-1)
    nl, per = tl.shape[1], CHUNK // LEAF
    # Each chunk's winner: its leaves' least t, the first leaf on a tie.
    tpad = torch.nn.functional.pad(tl, (0, nc * per - nl), value=_BIG).reshape(Rp, nc, per)
    ipad = torch.nn.functional.pad(il, (0, nc * per - nl), value=-1).reshape(Rp, nc, per)
    first = tpad.argmin(dim=2, keepdim=True)
    tc, ic = tpad.gather(2, first)[..., 0], ipad.gather(2, first)[..., 0]
    tn, ok = chunk_entry(clo, chi, o, d, cslack)
    ok &= alive[:, None]
    ltn, lok = leaf_entry(rows, cslack, o, d)
    lanes = torch.arange(Rp, device=dev)

    def take(x, j):  # x[r, j[r]]
        return x[lanes, j]

    def better(go, tj, ij, t, i):
        """Lanes ``go`` take (tj, ij) where it is the lesser (t, index) pair."""
        win = go & ((tj < t) | ((tj == t) & (ij < i)))
        return torch.where(win, tj, t), torch.where(win, ij, i)

    def visit(j, go, t, i):
        """Lanes ``go`` test chunk j[r]."""
        return better(go, take(tc, j), take(ic, j), t, i)

    # (a), (b), (c), (e): each lane's best t runs the same course in index
    # order whatever the vote; the vote only decides who pays.
    t = torch.full((Rp,), _BIG, device=dev)
    i = torch.full((Rp,), -1, dtype=torch.int64, device=dev)
    reach = torch.zeros(Rp, nc, dtype=torch.bool, device=dev)
    for j in range(nc):
        reach[:, j] = ok[:, j] & (tn[:, j] <= t)
        t, i = visit(torch.full((Rp,), j, device=dev), reach[:, j], t, i)
    t_final = t
    count = {"e": reach.sum(1)}
    for rule, size in (("a", 256), ("b", 128), ("c", WARP_RAYS)):
        count[rule] = reach.reshape(-1, size, nc).any(1).sum(1).repeat_interleave(size)
    count["g"] = (ok & (tn <= t_final[:, None])).sum(1)

    # (f): each lane alone, by its own entry distances.
    order = torch.where(ok, tn, float("inf")).argsort(dim=1, stable=True)
    t = torch.full((Rp,), _BIG, device=dev)
    i = torch.full((Rp,), -1, dtype=torch.int64, device=dev)
    count["f"] = torch.zeros(Rp, dtype=torch.int64, device=dev)
    for p in range(nc):
        j = order[:, p]
        go = take(ok, j) & (take(tn, j) <= t)
        count["f"] += go
        t, i = visit(j, go, t, i)

    # (d): the kernels' rule.
    W = Rp // WARP_RAYS
    keys = _entry_key(tn)
    t = torch.full((Rp,), _BIG, device=dev)
    i = torch.full((Rp,), -1, dtype=torch.int64, device=dev)
    count["d"] = torch.zeros(Rp, dtype=torch.int64, device=dev)
    leaves = torch.zeros(Rp, dtype=torch.int64, device=dev)
    group = torch.zeros(Rp // 128, nc, dtype=torch.bool, device=dev)
    warp_group = torch.arange(W, device=dev) // 2
    for w0 in range(0, nc, WINDOW):
        nw = min(WINDOW, nc - w0)
        reach0 = ok[:, w0:w0 + nw] & (tn[:, w0:w0 + nw] <= t[:, None])
        k = torch.where(reach0, keys[:, w0:w0 + nw], _NONE).reshape(W, WARP_RAYS, nw).amin(1)
        q = torch.arange(nw, device=dev)
        k = torch.where(k == _NONE, _NONE, (k & ~31) | q).sort(dim=1).values
        for p in range(nw):
            seen = k[:, p] != _NONE
            if not bool(seen.any()):
                break
            jw = torch.where(seen, w0 + (k[:, p] & 31), 0)
            j = jw.repeat_interleave(WARP_RAYS)
            go = seen.repeat_interleave(WARP_RAYS) & take(ok, j) & (take(tn, j) <= t)
            vote = go.reshape(W, WARP_RAYS).any(1)
            count["d"] += vote.repeat_interleave(WARP_RAYS)
            group[warp_group[vote], jw[vote]] = True
            for h in range(per):  # the chunk's leaves, each lane its own
                lf = (j * per + h).clamp_max(nl - 1)
                lgo = go & (j * per + h < nl) & take(lok, lf) & (take(ltn, lf) <= t)
                leaves += lgo
                t, i = better(lgo, take(tl, lf), take(il, lf), t, i)
    n_live = max(int(live.sum()), 1)
    groups = -(-R // 128)
    return dict(
        mean={r: float(count[r][:R][live].sum()) / n_live for r in sorted(RULES)},
        leaves=float(leaves[:R][live].sum()) / n_live, tested=group.sum(1)[:groups], idx=i[:R], t=t[:R],
    )
