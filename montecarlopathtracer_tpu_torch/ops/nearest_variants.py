"""The superseded selection entries of the JAX package, as thin entries
over the split path's intersector.

The counterpart of ``nearest_shade``, ``nearest_shade2``,
``nearest_shade_streamed`` and ``nearest_shade_culled`` in
``montecarlopathtracer_tpu/ops/intersect_pallas.py`` (TPU kernels
``_nearest_idx_kernel``, ``_nearest_idx_kernel_v2``,
``_nearest_idx_kernel_v3`` and ``_nearest_shade_culled_kernel``; B8-B11
of PERF.md). No renderer path calls them; the selection benchmark
(:mod:`..tools.kernel_bench`) and ``chip_smoke.py``'s intersector gate
do. Each TPU kernel computes what the split path's intersector computes
(the nearest accepted triangle, then the winner's exact t, β, γ and
shading row, JAX ``_refine_winner_soa``) in a TPU layout of its own,
with TPU selection tricks (a division-free sign chain, an approximate or
Newton-refined reciprocal, the split-bf16 K = 48 contraction) that the
port does not carry over.

So each entry here unpacks its layout into the 48-float row table of
:func:`.segment_fused.pack_rows_full` (geometry 12 | shading 32 | pad 4)
and calls :func:`.nearest_shade.nearest_shade_full`: for CUDA tensors
the hand-written kernel ``csrc/nearest_shade.cu`` (B4; B4c for the
culling entries, over the triangle records that they build with their
unpacking, with the explicit |d'_z| > 1e-12 test of
``_nearest_shade_culled_kernel`` for :func:`nearest_shade_culled`, and
their chunk boxes regridded to B4c's 128-triangle tiles by
:func:`tile_boxes`), for CPU tensors its plain version. Each entry counts
the kernel launches it made under its own name (B8-B11, B10c).

Packers (bit-equal to JAX's, through numpy): :func:`pack_transforms`
``w f32[6, 8, T]``, :func:`pack_transforms_fused` ``wf f32[6T, 8]``
(chunk-major), :func:`pack_transforms_stream` ``ws f32[8, 6 T_pad]``
(chunk-major, component 2 stored as q = −o'_z, zero-padded) and
:func:`pack_shading_table` ``f32[T, 32]``. :func:`refine_winner_soa` is
the plain version of JAX ``_refine_winner_soa``.

Contract (JAX's): every entry returns (idx i32[R] (−1 = miss), tbg
f32[4, R] = (t or 3e38, β·hit, γ·hit, hit), shade f32[32, R], zero on a
miss); ties go to the smallest index; the culling entries return indices
in the table's (Morton) order. Where JAX's unculled kernels compute a
winner for a lane that is not live, these return a miss (B4's contract).
``exact``, ``ray_tile`` and ``interpret`` are not options here, and
``t_chunk`` only where it defines a packing.
"""

from __future__ import annotations

import torch

from ..utils.profiling import count_launch, launches
from . import nearest_shade as NS
from .cull import chunk_slack, cull_records

_BIG = 3.0e38
_TILE = 128  # B4c's triangles per tile, one chunk box each
T_CHUNK = 1024  # JAX _T_CHUNK: the default chunk of nearest_shade2's packing


def divisor_chunk(T: int, want: int, step: int = 128) -> int:
    """The largest chunk ≤ ``want``, in steps of ``step``, that divides
    ``T`` (JAX ``_divisor_chunk``; ``T`` a multiple of ``step``)."""
    if T <= 0 or T % step:
        raise ValueError(f"T must be a positive multiple of {step}, got {T}")
    c = min(want, T)
    while T % c:
        c -= step
    return c


def pack_transforms(m, m_a, tri_valid) -> torch.Tensor:
    """``w f32[6, 8, T]`` (JAX ``pack_transforms``): component k < 3 is
    o'_k = m[:, k]·o − m_a[:, k] as the contraction [m_k0 m_k1 m_k2 −m_ak
    0 0 0 0] with the ray vector [o, 1, d, 0], component k ≥ 3 is
    d'_{k−3} as [0 0 0 0 m_k0 m_k1 m_k2 0]; zero for an invalid
    triangle."""
    v = tri_valid.to(m.dtype)
    mt = (m * v[:, None, None]).permute(1, 2, 0)  # [3(i), 3(j), T]
    ma = (m_a * v[:, None]).T  # [3, T]
    T = m.shape[0]
    z4 = torch.zeros(4, T, dtype=m.dtype, device=m.device)
    z1 = torch.zeros(1, T, dtype=m.dtype, device=m.device)
    comps = [torch.cat([mt[k], -ma[k:k + 1], z4]) for k in range(3)]
    comps += [torch.cat([z4, mt[k], z1]) for k in range(3)]
    return torch.stack(comps)


def pack_transforms_fused(m, m_a, tri_valid, t_chunk: int) -> torch.Tensor:
    """``wf f32[6T, 8]`` (JAX ``pack_transforms_fused``): row
    ``(ci·6 + k)·t_chunk + tl`` is component k of triangle
    ``ci·t_chunk + tl``; T must divide into chunks."""
    w = pack_transforms(m, m_a, tri_valid)
    T = w.shape[2]
    if T % t_chunk:
        raise ValueError(f"{T} triangles do not divide into chunks of {t_chunk}")
    nc = T // t_chunk
    return w.reshape(6, 8, nc, t_chunk).permute(2, 0, 3, 1).reshape(6 * T, 8).contiguous()


def pack_transforms_stream(m, m_a, tri_valid, t_chunk: int, pad_to: int = 0) -> torch.Tensor:
    """``ws f32[8, 6 T_pad]`` (JAX ``pack_transforms_stream``): column
    ``(ci·6 + k)·t_chunk + tl`` is component k of triangle
    ``ci·t_chunk + tl``, component 2 stored as q = −o'_z, the triangle
    axis zero-padded to a multiple of max(``pad_to``, ``t_chunk``)."""
    w = pack_transforms(m, m_a, tri_valid)
    w[2] = -w[2]
    T = w.shape[2]
    unit = max(pad_to, t_chunk)
    if unit % t_chunk:
        raise ValueError(f"pad_to {pad_to} is not a multiple of t_chunk {t_chunk}")
    T_pad = -(-T // unit) * unit
    if T_pad != T:
        w = torch.cat([w, torch.zeros(6, 8, T_pad - T, dtype=w.dtype, device=w.device)], dim=2)
    nc = T_pad // t_chunk
    return w.reshape(6, 8, nc, t_chunk).permute(1, 2, 0, 3).reshape(8, 6 * T_pad).contiguous()


def pack_shading_table(scene) -> torch.Tensor:
    """Per-triangle shading rows f32[T, 32] (JAX ``pack_shading_table``):
    n0 n1 n2 Ka Kd Ks Ns Tr Ni, then 11 zeros."""
    n0, n1, n2 = scene.triangle_normals()
    mid = scene.tri_mat.long()
    table = torch.cat([n0, n1, n2, scene.mat_ka[mid], scene.mat_kd[mid], scene.mat_ks[mid],
                       scene.mat_ns[mid][:, None], scene.mat_tr[mid][:, None],
                       scene.mat_ni[mid][:, None]], dim=1)
    pad = torch.zeros(table.shape[0], 32 - table.shape[1], dtype=table.dtype,
                      device=table.device)
    return torch.cat([table, pad], dim=1).contiguous()


def _geometry(w) -> torch.Tensor:
    """Geometry rows f32[T, 12] of ``w f32[6, 8, T]``: [m_k0 m_k1 m_k2
    −m_ak] for k = 0..2 (JAX ``w[:3, :4, :].reshape(12, -1).T``)."""
    return w[:3, :4, :].reshape(12, -1).T


def _unfuse(wf, t_chunk: int) -> torch.Tensor:
    """``w f32[6, 8, T]`` of a :func:`pack_transforms_fused` packing."""
    T6 = wf.shape[0]
    if wf.dim() != 2 or wf.shape[1] != 8 or T6 % (6 * t_chunk):
        raise ValueError(f"wf must be [6 T, 8] with T a multiple of t_chunk {t_chunk}, "
                         f"got {tuple(wf.shape)}")
    nc = T6 // (6 * t_chunk)
    return wf.reshape(nc, 6, t_chunk, 8).permute(1, 3, 0, 2).reshape(6, 8, nc * t_chunk)


def _unstream(ws, t_chunk: int) -> torch.Tensor:
    """``w f32[6, 8, T_pad]`` of a :func:`pack_transforms_stream`
    packing, o'_z restored from q = −o'_z (a negation, exact)."""
    if ws.dim() != 2 or ws.shape[0] != 8 or ws.shape[1] % (6 * t_chunk):
        raise ValueError(f"ws must be [8, 6 T_pad] with T_pad a multiple of t_chunk "
                         f"{t_chunk}, got {tuple(ws.shape)}")
    nc = ws.shape[1] // (6 * t_chunk)
    w = ws.reshape(8, nc, 6, t_chunk).permute(2, 0, 1, 3).reshape(6, 8, nc * t_chunk)
    return torch.cat([w[:2], -w[2:3], w[3:]])


def _rows(geom, table) -> torch.Tensor:
    """The row table f32[T, 48] (geometry 12 | shading 32 | pad 4) of the
    first T = ``table.shape[0]`` geometry rows; further rows of ``geom``
    are padding that never wins."""
    T = table.shape[0]
    if geom.shape[0] < T or table.dim() != 2 or table.shape[1] != 32:
        raise ValueError(f"need table [T, 32] and at least T geometry rows, got "
                         f"{tuple(table.shape)} and {tuple(geom.shape)}")
    pad = torch.zeros(T, 4, dtype=table.dtype, device=table.device)
    return torch.cat([geom[:T], table, pad], dim=1).contiguous()


def rows_from_w(w, table) -> torch.Tensor:
    """B4's row table f32[T, 48] of ``w f32[6, 8, T]`` and ``table``:
    what B8 and B11 unpack before their B4 launch."""
    return _rows(_geometry(w), table)


def rows_from_fused(wf, table, t_chunk: int = T_CHUNK) -> torch.Tensor:
    """As :func:`rows_from_w` for B9's packing ``wf f32[6 T_pad, 8]``."""
    return rows_from_w(_unfuse(wf, t_chunk), table)


def rows_from_streamed(ws, table, t_chunk: int = 256) -> torch.Tensor:
    """As :func:`rows_from_w` for B10's packing ``ws f32[8, 6 T_pad]``."""
    return rows_from_w(_unstream(ws, t_chunk), table)


def tile_boxes(clo, chi, box: int, T: int):
    """The chunk boxes (f32[ceil(T / 128), 3] each) of B4c's 128-triangle
    tiles, from boxes ``clo``, ``chi`` of ``box`` consecutive triangles
    each: a tile's box is the union of the boxes its triangles lie in. A
    wider box only culls less, so the winners do not change."""
    n = -(-T // _TILE)
    if box == _TILE:
        return clo[:n].contiguous(), chi[:n].contiguous()
    tri = torch.arange(T, device=clo.device)
    src, dst = tri // box, (tri // _TILE)[:, None].expand(T, 3)

    def union(x, how):
        out = torch.empty(n, 3, dtype=x.dtype, device=x.device)
        return out.scatter_reduce_(0, dst, x[src], how, include_self=False)

    return union(clo, "amin"), union(chi, "amax")


def _all_live(pos3) -> torch.Tensor:
    return torch.ones(pos3.shape[1], dtype=torch.bool, device=pos3.device)


def _select(name, rows, pos3, dir3, live, **kw):
    """:func:`.nearest_shade.nearest_shade_full` on the unpacked rows,
    counting under ``name`` the B4 or B4c launches it made."""
    before = launches()
    out = NS.nearest_shade_full(rows, pos3, dir3, live, **kw)
    made = launches() - before
    count_launch(name, made["B4"] + made["B4c"])
    return out


def refine_winner_soa(geom, table, idx, pos3, dir3):
    """(tbg f32[4, R], shade f32[32, R]) of the winners ``idx`` i32[R]
    (−1 = miss) in plain f32, from the geometry rows ``geom`` f32[T, 12]
    and the shading table f32[T, 32] (JAX ``_refine_winner_soa``, whose
    rays argument is [pos3, 1, dir3, 0]): t = −o'_z / d'_z (3e38 where
    |d'_z| ≤ 1e-12), β = o'_x + t·d'_x, γ = o'_y + t·d'_y."""
    hit = idx >= 0
    hitf = hit.to(torch.float32)
    tid = idx.clamp_min(0).long()
    g = geom[tid].T
    o, d = pos3, dir3

    def prime(base):
        m0, m1, m2, nma = g[base], g[base + 1], g[base + 2], g[base + 3]
        return m0 * o[0] + m1 * o[1] + m2 * o[2] + nma, m0 * d[0] + m1 * d[1] + m2 * d[2]

    opx, dpx = prime(0)
    opy, dpy = prime(4)
    opz, dpz = prime(8)
    safe = dpz.abs() > 1e-12
    t = torch.where(safe, -opz / torch.where(safe, dpz, 1.0), _BIG)
    tbg = torch.stack([torch.where(hit, t, _BIG), torch.where(hit, opx + t * dpx, 0.0),
                       torch.where(hit, opy + t * dpy, 0.0), hitf])
    return tbg, table[tid].T * hitf[None, :]


def nearest_shade(w, table, pos3, dir3):
    """Nearest hit + exact (t, β, γ, hit) + shading row (JAX
    ``nearest_shade``, TPU kernel ``_nearest_idx_kernel``, B8) over
    ``w f32[6, 8, T]`` (:func:`pack_transforms`) and ``table f32[T, 32]``
    for rays ``pos3``, ``dir3`` f32[3, R]: B4 on the unpacked rows."""
    return _select("B8", rows_from_w(w, table), pos3, dir3, _all_live(pos3))


def nearest_shade2(wf, geom, table, pos3, dir3, *, t_chunk: int = T_CHUNK):
    """As :func:`nearest_shade` over the chunk-major packing ``wf
    f32[6 T_pad, 8]`` of :func:`pack_transforms_fused` with chunk
    ``t_chunk`` (JAX ``nearest_shade2``, TPU kernel
    ``_nearest_idx_kernel_v2``, B9): B4 on the unpacked rows. ``geom``
    f32[T, 12] (JAX ``pack_geom_rows``) holds the same values for the
    valid triangles; its shape is checked, and the rows come from ``wf``,
    which the selection reads."""
    _check_geom(geom, table)
    return _select("B9", rows_from_fused(wf, table, t_chunk), pos3, dir3,
                   _all_live(pos3))


def nearest_shade_streamed(ws, geom, table, pos3, dir3, live=None, clo=None, chi=None, *,
                           t_chunk: int = 256, cull: bool = False, cslack=None):
    """As :func:`nearest_shade` over the streamed packing ``ws f32[8, 6
    T_pad]`` of :func:`pack_transforms_stream` with chunk ``t_chunk``
    (JAX ``nearest_shade_streamed``, TPU kernel ``_nearest_idx_kernel_v3``,
    B10), for the lanes of ``live`` bool[R] (None: all). With ``cull``,
    the triangle axis is in Morton order and ``clo``, ``chi`` f32[T_pad /
    t_chunk, 3] are the boxes of its chunks (JAX ``chunk_aabbs_padded``):
    B4c on those boxes regridded to its tiles, with their slack ``cslack``
    (:func:`.cull.chunk_slack` of the unpacked rows, computed here when not
    given) and the unpacked rows' records (:func:`.cull.cull_records`,
    built here with the unpacking); else B4. ``geom`` as in
    :func:`nearest_shade2`."""
    _check_geom(geom, table)
    rows = rows_from_streamed(ws, table, t_chunk)
    live = _all_live(pos3) if live is None else live.to(torch.bool).contiguous()
    boxes = {}
    if cull:
        nc = ws.shape[1] // (6 * t_chunk)
        if clo is None or chi is None or clo.shape[0] != nc or chi.shape[0] != nc:
            raise ValueError(f"cull needs chunk boxes clo, chi [{nc}, 3]")
        # The boxes past the table cover padding only.
        boxes = dict(zip(("clo", "chi"), tile_boxes(clo, chi, t_chunk, rows.shape[0])),
                     cslack=chunk_slack(rows) if cslack is None else cslack,
                     crec=cull_records(rows))
    return _select("B10c" if cull else "B10", rows, pos3, dir3, live, **boxes)


def nearest_shade_culled(w, table, clo, chi, pos3, dir3, live, cslack=None):
    """As :func:`nearest_shade` over ``w f32[6, 8, T]`` in Morton order
    with its chunk boxes ``clo``, ``chi`` f32[nc, 3], one per T / nc
    consecutive triangles, for the lanes of ``live`` (JAX
    ``nearest_shade_culled``, TPU kernel ``_nearest_shade_culled_kernel``,
    B11): B4c, on those boxes regridded to its tiles and widened by
    ``cslack``, over the records built with the unpacking (as in
    :func:`nearest_shade_streamed`), with the explicit |d'_z| > 1e-12 test
    of that kernel."""
    T, nc = w.shape[2], clo.shape[0]
    if nc == 0 or T % nc or chi.shape[0] != nc:
        raise ValueError(f"{T} triangles do not divide into {nc} chunk boxes")
    clo, chi = tile_boxes(clo, chi, T // nc, T)
    rows = rows_from_w(w, table)
    return _select("B11", rows, pos3, dir3, live.to(torch.bool).contiguous(),
                   clo=clo, chi=chi, cslack=chunk_slack(rows) if cslack is None else cslack,
                   crec=cull_records(rows), dz_test=True)


def _check_geom(geom, table) -> None:
    if geom.dim() != 2 or geom.shape[1] != 12 or geom.shape[0] != table.shape[0]:
        raise ValueError(f"geom must be [T, 12] for a table of {table.shape[0]} rows, "
                         f"got {tuple(geom.shape)}")

