"""A whole pass of the regenerating wavefront (kernel B1r) and its plain
versions.

The counterpart of the JAX package's regen device program
(``montecarlopathtracer_tpu/render/regen.py``: a ``lax.while_loop`` under
``jit`` over the per-lane-flag segment kernel, with the bookkeeping fused
around it by XLA). Lane ``i`` is pinned to pixel ``i`` of the band
[y0, y0 + n_rows) and traces that pixel's ``spp`` samples back to back;
see :mod:`..render.regen` for the estimator and its stream ids.

- :func:`regen_pass` is the entry point. For a CUDA device it launches
  ``csrc/regen_pass.cu`` once (counted as B1r, or as B1rc for the
  culled instance), with no host sync. A persistent grid of blocks
  pulls lanes from a device-side work list into free slots and runs
  each lane in its slot from its first step to its last; a lane
  carries its own step, so its draws and flags
  do not depend on which slot or block runs it, so the list may hand
  the lanes out in any order (``order``; :func:`longest_first` builds
  one from a pass's ``lane_steps``). A block whose list is spent traces
  its last lanes packed, several threads a lane. For the CPU it runs
  :func:`regen_pass_ref`. It never falls back from one to the other: a
  build or launch failure raises.
- :func:`regen_pass_ref` is the host loop: one whole segment per step
  through :func:`..render.integrator.segment_step` (B1l on the card, its
  plain version on the CPU or under ``testing.plain_kernels()``), with
  the live mask read every :data:`LIVE_CHECK_EVERY` steps. It also
  serves the traversal path, which has no pass kernel: there each step
  launches B5 and B6l.
- :func:`regen_pass_scheduled` runs the pass as the kernel schedules it,
  in plain torch: blocks of slots pulling lanes from the work list, the
  per-lane step, lanes leaving their slots when done.
- :func:`longest_first` orders the work list by a pass's ``lane_steps``,
  longest lanes first.
- :func:`pass_keys` folds every stream key of a pass on the host (the
  table the kernel reads); :func:`camera_rays_ref` is the kernel's camera
  ray in plain torch, in its operation order; :func:`origin_bound` the
  bound on every origin of a pass that the kernel widens its staged
  spheres for.

All return ``(accum f32[3, R], lane_steps i32[R])`` (the schedule its
counters too): the sum of each lane's samples (the caller divides by
``spp``) and the step at which each lane's last path ended (``spp *
num_segments + 1`` if the backstop stopped it with a path live, which
cannot happen: every path ends within ``num_segments`` segments). A lane
is live at every step from its first until that one, so ``lane_steps``
is also each lane's count of steps.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.profiling import count_launch, keep, span
from . import cuda_build
from . import rng
from .rng import Key

LIVE_CHECK_EVERY = 8  # host-loop steps between two reads of the live mask
# The counters of a pass, i64[len(STATS)]: the steps the blocks ran, the
# slot-steps (block-steps x slots a block), the live lane-steps, the
# lane-steps whose origin exceeded the staged bound (the plain instance's
# whole table; those lanes test every triangle exactly), the culled
# loop's chunks tested x the live lanes of the block-step, the blocks that
# ran a step, the culled loop's leaves tested by a warp (each warp's
# voted leaves, summed) and those of them that took the pair path
# (csrc/sphere_select.cuh ``test_pairs``); then the card's clock (ns) at
# the first block start, when a block first found the list spent, and at
# the last block end, kept as -1 - t, -1 - t and t (:func:`pass_clocks`
# decodes them).
STATS = ("block_steps", "slot_steps", "live_steps", "overflow", "vote_chunks", "blocks",
         "leaf_visits", "pair_leaves", "t_start", "t_spent", "t_end")
COUNTERS = STATS[:STATS.index("t_start")]  # the fields that add up over passes
_KEY_SLOTS = 5  # a step's streams: u1, u2, urr, jitter x, jitter y
_M32 = 0xFFFFFFFF
_JITTER = 1 << 30  # first jitter stream
_BUCKET_SHIFT = 5  # longest_first compares lane_steps >> 5: lengths in buckets of 32 steps


def slots_per_block(config) -> int:
    """Lane slots of a block of the kernel for ``config``: two a thread,
    128 threads (csrc/sphere_select.cuh kSelThreads), 64 with chunk_cull
    (kCullThreads)."""
    return 128 if config.chunk_cull else 256


def max_steps(spp: int, config) -> int:
    """The loop's backstop: ``spp * num_segments + 1`` (every path ends
    within ``num_segments`` segments, so the steps stay below it)."""
    return spp * config.num_segments + 1


def longest_first(lane_steps: torch.Tensor) -> torch.Tensor:
    """The work list's order for a pass whose lanes take about
    ``lane_steps`` i32[R] steps (a previous pass's of the same band, spp
    and tables): i32[R] on its device, a stable sort of the lanes by
    ``lane_steps >> 5`` descending, with no host sync. Lanes of one bucket
    of 32 steps keep their row order, so equal lengths give the identity.

    Handing the longest lanes out first leaves short ones to run while
    the slots empty after the list is spent (longest-first list
    scheduling); the order never changes what a lane computes."""
    buckets = lane_steps >> _BUCKET_SHIFT
    return torch.sort(buckets, descending=True, stable=True).indices.to(torch.int32)


def _threefry(k0, k1, ks2, x1):
    """Threefry-2x32 (20 rounds) of counter words (0, x1) under keys
    (k0, k1) and k0 ^ k1 ^ 0x1BD11BDA = ks2, on numpy uint32 arrays
    (scalars or one key per element): the two output words."""
    ks = (k0, k1, ks2)
    x0 = np.zeros(np.broadcast(k0, x1).shape, np.uint32) + k0
    x1 = np.asarray(x1, np.uint32) + k1
    for i in range(5):
        for r in rng._ROT[i % 2]:
            x0 += x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def fold_in_many(key: Key, data: np.ndarray):
    """:func:`.rng.fold_in` of every entry of ``data`` (uint32-valued) at
    once, on numpy uint32 arrays: (k0, k1) uint32 arrays."""
    k0, k1 = (np.full(1, k, np.uint32) for k in key)  # arrays: their sums wrap silently
    data = (np.asarray(data, np.uint64) & _M32).astype(np.uint32)
    return _threefry(k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA), data)


def uniform_lanes(keys: np.ndarray, lanes: np.ndarray) -> np.ndarray:
    """The uniform of counter ``lanes[i]`` under key ``keys[i]`` (u32[n,
    2] folded keys, as :func:`pass_keys` holds them), f32[n]: element
    ``lanes[i]`` of ``jax.random.uniform`` under that key, as the kernel
    draws it (threefry.cuh's ``uniform``)."""
    k0, k1 = keys[..., 0], keys[..., 1]
    x0, x1 = _threefry(k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA), lanes.astype(np.uint32))
    mant = ((x0 ^ x1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return mant.view(np.float32) - np.float32(1.0)


def stream_ids(steps: int) -> np.ndarray:
    """The stream ids of a pass, i64[steps, 5]: row ``s`` >= 1 holds step
    ``s``'s u1, u2, urr streams ``(s-1)*4 + {0, 1, 3}`` and the jitter
    streams of the camera rays regenerated after it, ``(1<<30) + 2s`` and
    ``(1<<30) + 2s + 1``; row 0 holds the first wavefront's jitter
    streams ``1<<30`` and ``(1<<30) + 1`` (its first three slots are
    unused, 0)."""
    ids = np.zeros((steps, _KEY_SLOTS), np.int64)
    s = np.arange(1, steps)
    ids[1:, 0], ids[1:, 1], ids[1:, 2] = 4 * (s - 1), 4 * (s - 1) + 1, 4 * (s - 1) + 3
    ids[0, 3:] = (_JITTER, _JITTER + 1)
    ids[1:, 3], ids[1:, 4] = _JITTER + 2 * s, _JITTER + 2 * s + 1
    return ids


def pass_keys(key: Key, steps: int) -> np.ndarray:
    """The folded keys of every stream of a pass of ``steps`` steps (the
    backstop), u32[steps, 5, 2]: ``fold_in(key, stream_ids(steps))`` as
    (k0, k1) pairs, with row 0's unused slots zero."""
    ids = stream_ids(steps)
    k0, k1 = fold_in_many(key, ids)
    keys = np.stack([k0, k1], axis=-1)
    keys[0, :3] = 0
    return keys


def camera_table(camera) -> torch.Tensor:
    """The camera as the kernel reads it, f32[14] on its device: eye,
    right, up, forward, tan_half_x, tan_half_y."""
    return torch.cat([camera.eye, camera.right, camera.up, camera.forward,
                      camera.tan_half_x.reshape(1), camera.tan_half_y.reshape(1)]).to(
        torch.float32).contiguous()


def camera_rays_ref(camera, xs, ys, ux, uy, width: int, height: int, scalar_div: str = "card"):
    """The kernel's camera ray (``regen_pass.cu::camera_ray``) in plain
    torch, one operation per kernel operation and in its order: pixel
    ``(xs, ys)`` with uniforms ``ux``, ``uy`` in [0, 1), jitter ``2 u - 1``;
    (origins f32[3, R], unit directions f32[3, R]).

    It is ``Camera.generate_rays_soa`` with the division by the image's
    width and height as torch performs it on ``scalar_div``'s device: on
    the card (``"card"``, what the kernel does) torch divides a tensor by
    a Python number as a multiply by the number's f32 reciprocal, on the
    CPU (``"cpu"``) as an IEEE division; the two differ by an ulp where
    ``1 / W`` is inexact."""
    if scalar_div not in ("card", "cpu"):
        raise ValueError(f"scalar_div must be 'card' or 'cpu', got {scalar_div!r}")
    f32 = torch.float32
    jx = ux * 2.0 - 1.0
    jy = uy * 2.0 - 1.0
    bx = xs.to(f32) + jx * camera.jitter
    by = ys.to(f32) + jy * camera.jitter

    def over(v, n):
        if scalar_div == "cpu":
            return v / n
        return v * torch.tensor(np.float32(1.0) / np.float32(n), device=v.device)

    dx = (over(2.0 * bx, width) - 1.0) * camera.tan_half_x
    dy = (1.0 - over(2.0 * by, height)) * camera.tan_half_y
    c = [(camera.right[k] * dx + camera.up[k] * dy) + camera.forward[k] for k in range(3)]
    n = torch.sqrt((c[0] * c[0] + c[1] * c[1]) + c[2] * c[2])
    d = torch.stack([c[0] / n, c[1] / n, c[2] / n])
    return camera.eye[:, None].expand(d.shape), d


def vertex_norm(rows: torch.Tensor) -> torch.Tensor:
    """The largest finite |vertex| of a row table f32[T, 48], f64[] on its
    device, computed there without a host sync. The vertices come from
    each row's geometry [m | -m_a] in float64: m^-1 = [c0 c1 c2] / det
    with c0 = m1 x m2, c1 = m2 x m0, c2 = m0 x m1, A = m^-1 m_a, B = A +
    m^-1 e_x, C = A + m^-1 e_y; a row with det 0 (the padding) gives no
    finite vertex. ``SceneTables.vertex_norm`` keeps it once a table."""
    g = rows.detach()[:, :12].to(torch.float64).reshape(-1, 3, 4)
    m, a = g[:, :, :3], -g[:, :, 3]
    c0 = torch.linalg.cross(m[:, 1], m[:, 2])
    c1 = torch.linalg.cross(m[:, 2], m[:, 0])
    c2 = torch.linalg.cross(m[:, 0], m[:, 1])
    det = (m[:, 0] * c0).sum(-1, keepdim=True)
    A = (a[:, :1] * c0 + a[:, 1:2] * c1 + a[:, 2:] * c2) / det
    norms = torch.stack([A, A + c0 / det, A + c1 / det]).norm(dim=-1)
    if not norms.numel():
        return torch.zeros((), dtype=torch.float64, device=rows.device)
    return torch.where(torch.isfinite(norms), norms, 0.0).amax()


def origin_bound(tables, eye: torch.Tensor, eps_offset: float) -> torch.Tensor:
    """A bound on |o| of every ray origin of a pass over ``tables``, f32[1]
    on their device, computed there without a host sync: the larger of
    |eye| and the table's largest finite |vertex| (``tables.vertex_norm``,
    :func:`vertex_norm`), plus |eps_offset|, times 1 + 2^-10. An origin is
    the eye or a hit point o + t d (on a triangle within f32 rounding)
    moved eps_offset along a unit direction."""
    eye = eye.detach().to(torch.float64).norm()
    bound = (torch.maximum(tables.vertex_norm, eye) + abs(eps_offset)) * (1.0 + 2.0 ** -10)
    return bound.to(torch.float32).reshape(1)


# ---------------------------------------------------------------- plain versions

def _band(width, height, n_rows):
    n_rows = n_rows or height
    return n_rows, width * n_rows


def _loop(tables, config, camera, key, width, height, spp, y0, R, on_step=None):
    """The host loop over the R lanes of a band: (accum f32[3, R],
    lane_steps i32[R]). ``on_step(pos, dir_, live)`` sees each step's
    wavefront before its segment."""
    from ..render.integrator import segment_step

    dev = camera.device
    lanes = torch.arange(R, device=dev)
    xs = lanes % width
    ys = lanes // width + y0

    def camera_rays(step):
        base = _JITTER if step == 0 else _JITTER + 2 * step
        jx, jy = rng.stream_uniforms(key, (base, base + 1), R, dev) * 2.0 - 1.0
        return camera.generate_rays_soa(xs, ys, jx, jy, width, height)

    pos, dir_ = camera_rays(0)
    pos, dir_ = pos.contiguous(), dir_.contiguous()
    tput = torch.ones(3, R, device=dev)
    res = torch.zeros(3, R, device=dev)
    accum = torch.zeros(3, R, device=dev)
    live = torch.ones(R, dtype=torch.bool, device=dev)
    depth = torch.zeros(R, dtype=torch.int64, device=dev)  # within the current path
    done = torch.zeros(R, dtype=torch.int64, device=dev)  # samples completed
    last = torch.zeros(R, dtype=torch.int64, device=dev)  # the step its last path ended
    urr = torch.zeros(R, device=dev)
    rr = config.mode == "rr"
    stop = max_steps(spp, config)
    step = 1  # the segment at depth step - 1 when spp = 1
    while step < stop:
        with span("regen.step"):
            if (step - 1) % LIVE_CHECK_EVERY == 0 and not bool(live.any()):
                break
            sid = (step - 1) * 4
            u = rng.stream_uniforms(key, (sid, sid + 1, sid + 3)[:3 if rr else 2], R, dev)
            u1, u2 = u[0], u[1]
            if rr:
                urr = u[2]
            if on_step is not None:
                on_step(pos, dir_, live)
            npos, ndir, ntput, nres, still = segment_step(
                tables, config, pos, dir_, tput, res, live, u1, u2, urr,
                config.lane_flags(depth))
            still = still > 0.0
            ended = live & ~still
            accum = accum + torch.where(ended[None, :], nres, 0.0)
            regen = ended & (done + 1 < spp)
            last = torch.where(ended & ~regen, step, last)
            live = (live & still) | regen
            done = done + ended
            depth = torch.where(regen, 0, depth + 1)

            posr, dirr = camera_rays(step)
            rg = regen[None, :]
            pos = torch.where(rg, posr, npos)
            dir_ = torch.where(rg, dirr, ndir)
            tput = torch.where(rg, 1.0, ntput)
            res = torch.where(rg, 0.0, nres)
            step += 1
    return accum, torch.where(live, stop, last).to(torch.int32)


def regen_pass_ref(tables, config, camera, key: Key, width: int, height: int, spp: int,
                   y0: int = 0, n_rows: int = 0, on_step: Optional[Callable] = None,
                   order: Optional[torch.Tensor] = None):
    """Plain version of :func:`regen_pass` (see the module docstring): the
    host loop over one whole segment per step. ``on_step(pos, dir_,
    live)`` is called with each step's wavefront f32[3, R], f32[3, R],
    bool[R] before its segment: a measurement of the pass's work sees the
    rays each step traces. ``order`` is taken and ignored: the loop steps
    every lane at once, so it has no work list to order."""
    _, R = _band(width, height, n_rows)
    return _loop(tables, config, camera, key, width, height, spp, y0, R, on_step)


def regen_pass_scheduled(tables, config, camera, key: Key, width: int, height: int,
                         spp: int, y0: int = 0, n_rows: int = 0, *, blocks: int = 4,
                         slots: int = 64, order: Optional[torch.Tensor] = None):
    """The pass as the kernel schedules it, in plain torch: (accum f32[3,
    R], lane_steps i32[R], stats i64[len(STATS)]), the first two bit-equal
    to :func:`regen_pass_ref`'s. The stats count the schedule's steps,
    slots and blocks; the selection's own counters (``vote_chunks``,
    ``leaf_visits``, ``pair_leaves``: the kernel's warps, whose rays
    depend on when each warp fetched) and the clock fields stay 0.

    ``blocks`` blocks of ``slots`` slots run in lockstep ticks, block
    after block within a tick. A tick of a running block: its empty slots
    fetch the next entries of the work list (lane ``order[i]`` for entry
    ``i``, lane ``i`` without an order; each started at its step 0) until
    the list is spent; the block's vote counts its live
    slots; with none it exits; else every live slot runs one step of its
    own lane, and a lane that has done its samples leaves its slot. A step
    of lane ``i`` at its step ``s`` draws element ``i`` of the streams
    under ``pass_keys(key)[s]`` and takes its flags from its own path
    depth, so its result does not depend on the slot or block that runs
    it, nor on when it starts."""
    from ..render.integrator import segment_step

    if blocks < 1 or slots < 1:
        raise ValueError(f"blocks and slots must be positive, got {blocks}, {slots}")
    n_rows, R = _band(width, height, n_rows)
    _check_band(width, height, y0, n_rows, spp)
    dev = camera.device
    rr = config.mode == "rr"
    stop = max_steps(spp, config)
    keys = pass_keys(key, stop)
    i64 = torch.int64
    if order is None:
        order = torch.arange(R, dtype=torch.int32)
    _check_order(order, R)
    order = order.to(dev, i64)

    def draw(rows_, lanes):  # u32[n, 2] keys per lane -> f32[n] on dev
        return torch.from_numpy(uniform_lanes(rows_, lanes.cpu().numpy())).to(dev)

    def start(lanes, steps):  # the camera rays of the jitter keys of rows `steps`
        k = keys[steps.cpu().numpy()]
        jx = draw(k[:, 3], lanes) * 2.0 - 1.0
        jy = draw(k[:, 4], lanes) * 2.0 - 1.0
        return camera.generate_rays_soa(lanes % width, lanes // width + y0, jx, jy, width,
                                        height)

    accum = torch.zeros(3, R, device=dev)
    lane_steps = torch.zeros(R, dtype=torch.int32, device=dev)
    # The slots' registers: lane id (-1 empty), state, depth/done/step.
    n = blocks * slots
    lane = torch.full((n,), -1, dtype=i64, device=dev)
    reg = {k: torch.zeros(3, n, device=dev) for k in ("pos", "dir", "tput", "res")}
    meta = torch.zeros(3, n, dtype=i64, device=dev)
    stats = torch.zeros(len(STATS), dtype=i64)
    col = {name: i for i, name in enumerate(STATS)}
    head = 0
    running = list(range(blocks))
    ran = [0] * blocks
    while running:
        stepping = []
        for b in list(running):
            sl = slice(b * slots, (b + 1) * slots)
            empty = torch.nonzero(lane[sl] < 0).flatten() + b * slots
            if head < R and empty.numel():
                got = order[head:head + empty.numel()]
                head += got.numel()
                into = empty[:got.numel()]
                lane[into] = got
                meta[:, into] = 0
                reg["pos"][:, into], reg["dir"][:, into] = start(got, torch.zeros_like(got))
                reg["tput"][:, into], reg["res"][:, into] = 1.0, 0.0
            held = torch.nonzero(lane[sl] >= 0).flatten() + b * slots
            if held.numel() == 0:
                running.remove(b)
                continue
            ran[b] += 1
            stats[col["block_steps"]] += 1
            stats[col["live_steps"]] += held.numel()
            stepping.append(held)
        if not stepping:
            continue
        held = torch.cat(stepping)
        ids = lane[held]
        depth, done, step = meta[0, held], meta[1, held], meta[2, held] + 1
        if bool((step >= stop).any()):
            raise RuntimeError("a lane passed the backstop")
        k = keys[step.cpu().numpy()]
        u1, u2 = draw(k[:, 0], ids), draw(k[:, 1], ids)
        urr = draw(k[:, 2], ids) if rr else torch.zeros_like(u1)
        live = torch.ones(ids.numel(), dtype=torch.bool, device=dev)
        npos, ndir, ntput, nres, still = segment_step(
            tables, config, reg["pos"][:, held], reg["dir"][:, held],
            reg["tput"][:, held], reg["res"][:, held], live, u1, u2, urr,
            config.lane_flags(depth))
        still = still > 0.0
        ended = ~still
        accum[:, ids[ended]] += nres[:, ended]
        done = done + ended
        regen = ended & (done < spp)
        fin = ended & ~regen
        lane_steps[ids[fin]] = step[fin].to(torch.int32)
        posr, dirr = start(ids, step)
        rg = regen[None, :]
        old = {k: reg[k][:, held] for k in reg}
        reg["pos"][:, held] = torch.where(rg, posr, torch.where(still, npos, old["pos"]))
        reg["dir"][:, held] = torch.where(rg, dirr, torch.where(still, ndir, old["dir"]))
        reg["tput"][:, held] = torch.where(rg, 1.0, torch.where(still, ntput, old["tput"]))
        reg["res"][:, held] = torch.where(rg, 0.0, old["res"])
        meta[0, held] = torch.where(regen, 0, depth + 1)
        meta[1, held], meta[2, held] = done, step
        lane[held[fin]] = -1
    stats[col["slot_steps"]] = stats[col["block_steps"]] * slots
    stats[col["blocks"]] = sum(r > 0 for r in ran)
    return accum, lane_steps, stats


# ---------------------------------------------------------------- the kernel

class _Args(ctypes.Structure):
    """csrc/regen_pass.cu's ``RegenArgs`` (``SegOptions`` inlined)."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("R", "T", "width", "y0", "spp", "max_steps", "max_depth", "rr_depth")] + \
               [(name, ctypes.c_float) for name in ("jitter", "inv_w", "inv_h")] + \
               [("mode_rr", ctypes.c_int), ("illum", ctypes.c_float),
                ("eps_offset", ctypes.c_float), ("refract_kd", ctypes.c_int),
                ("phong_reflect", ctypes.c_int)]


_P = ctypes.c_void_p
_WHOLE_MAX = 760  # csrc/sphere_select.cuh kWholeMax: the tables staged whole


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("regen_pass")
    fn = lib.regen_pass_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [_P, _P, _P, _P, _P, ctypes.c_int,  # rows, clo, chi, cslack, rec, cull
                   _P, _P, _P, _P,  # keys, cam, omax, args
                   _P, _P, _P,  # accum, lane_steps, order
                   _P, ctypes.c_long, _P]  # work, grid, stream
    lib.regen_pass_resident.restype = ctypes.c_long
    lib.regen_pass_resident.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


@functools.cache
def _resident(T: int, cull: bool, device: int) -> int:
    """Blocks of the kernel that fit on card ``device`` at once over a
    T-row table (the occupancy calculator's, once per shape)."""
    with torch.cuda.device(device):
        n = int(_lib().regen_pass_resident(T, int(cull)))
    if n <= 0:
        raise RuntimeError(f"regen_pass: no occupancy for T={T}, cull={cull}")
    return n


def _grid(R: int, T: int, config, device: int) -> int:
    """The launch's blocks: those that fit at once, at most one per
    :func:`slots_per_block` lanes."""
    return min(-(-R // slots_per_block(config)), _resident(T, config.chunk_cull, device))


def _args(config, camera, R, T, width, height, y0, spp) -> _Args:
    kw = config.kernel_options()
    return _Args(R=R, T=T, width=width, y0=y0, spp=spp, max_steps=max_steps(spp, config),
                 max_depth=config.max_depth, rr_depth=config.rr_depth,
                 jitter=float(camera.jitter),
                 inv_w=float(np.float32(1.0) / np.float32(width)),
                 inv_h=float(np.float32(1.0) / np.float32(height)),
                 mode_rr=int(kw["mode"] == "rr"), illum=float(kw["illum"]),
                 eps_offset=float(kw["eps_offset"]), refract_kd=int(bool(kw["refract_kd"])),
                 phong_reflect=int(kw["phong_model"] == "phong"))


def _keys_on(dev, keys: np.ndarray) -> torch.Tensor:
    """The key table on ``dev`` as int32 (the kernel reads uint32), copied
    from pinned memory without a host sync."""
    host = torch.from_numpy(np.ascontiguousarray(keys).view(np.int32)).pin_memory()
    return host.to(dev, non_blocking=True)


def _check_order(order: torch.Tensor, R: int, dev: Optional[torch.device] = None):
    """An order's dtype and shape, and, given the device ``dev`` that
    reads it in place, that it is contiguous there (not that it is a
    permutation, which would take a host sync; see :func:`regen_pass` for
    what a bad one does)."""
    if order.dtype != torch.int32 or order.shape != (R,):
        raise ValueError(f"order must be an int32 tensor of the band's {R} lanes, got "
                         f"{order.dtype} {tuple(order.shape)}")
    if dev is not None and (order.device != dev or not order.is_contiguous()):
        raise ValueError(f"order must be contiguous on {dev}, got {order.device}")


def _check_band(width, height, y0, n_rows, spp):
    if width < 1 or height < 1 or not 0 <= y0 or y0 + n_rows > height:
        raise ValueError(f"rows [{y0}, {y0 + n_rows}) of a {width}x{height} frame")
    if spp < 1:
        raise ValueError(f"spp must be at least 1, got {spp}")
    if width * n_rows >= 2**31:
        raise ValueError("the band's lanes must fit in int32")


def _regen_pass_cuda(tables, config, camera, key, width, height, spp, y0, n_rows, stats,
                     order):
    from . import cull as CU
    from . import segment_fused as F

    if config.intersector != "megakernel":
        raise ValueError(f"the pass kernel runs intersector='megakernel', got "
                         f"{config.intersector!r}")
    n_rows, R = _band(width, height, n_rows)
    _check_band(width, height, y0, n_rows, spp)
    rows = tables.rows.detach()
    dev = rows.device
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != 48 \
            or not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("rows must be a contiguous, 16-byte aligned float32 [T, 48] tensor")
    T, cull = rows.shape[0], config.chunk_cull
    if order is not None:
        _check_order(order, R, dev)
    boxes = (None,) * 4
    if cull:
        F.check_chunk_boxes(rows, tables.clo, tables.chi, tables.cslack)
        crec = tables.crec if tables.crec is not None else CU.cull_records(rows)
        CU.check_records(crec, rows)
        boxes = (tables.clo.data_ptr(), tables.chi.data_ptr(), tables.cslack.data_ptr(),
                 crec.data_ptr())
    lib = _lib()
    with span("regen.keys"):
        keys = _keys_on(dev, pass_keys(key, max_steps(spp, config)))
    with span("regen.launch"):
        cam = camera_table(camera)
        # Only the whole-table instance stages spheres for a bound on |o|.
        omax = origin_bound(tables, camera.eye, config.eps_offset) \
            if not cull and T <= _WHOLE_MAX else None
        args = _args(config, camera, R, T, width, height, y0, spp)
        accum = torch.empty(3, R, device=dev)
        lane_steps = torch.empty(R, dtype=torch.int32, device=dev)
        # The stats, then the list head.
        work = torch.empty(len(STATS) + 1, dtype=torch.int64, device=dev)
        grid = _grid(R, T, config,
                     torch.cuda.current_device() if dev.index is None else dev.index)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.regen_pass_launch(rows.data_ptr(), *boxes, int(cull), keys.data_ptr(),
                                        cam.data_ptr(), None if omax is None else omax.data_ptr(),
                                        ctypes.byref(args), accum.data_ptr(),
                                        lane_steps.data_ptr(),
                                        None if order is None else order.data_ptr(),
                                        work.data_ptr(), grid, stream)
    if err != 0:
        raise RuntimeError(f"regen_pass kernel launch failed: cudaError {err}")
    count_launch("B1rc" if cull else "B1r")
    keep(work, grid, ordered=order is not None,
         chunks=tables.clo.shape[0] if cull else 0)
    if stats is not None:
        stats["counters"] = work[:len(STATS)]
        stats["omax"] = omax
        stats["grid"] = grid
    return accum, lane_steps


def pass_clocks(counters: torch.Tensor) -> torch.Tensor:
    """The card's clock (ns) at a pass's first block start, when a block
    first found its list spent, and at its last block end, i64[..., 3],
    from counters i64[..., len(STATS)] (one pass's or stacked): the
    kernel keeps the first two as -1 - t; spent is -1 where no block found
    the list spent (kept as 0)."""
    start, spent, end = counters[..., STATS.index("t_start"):].unbind(-1)
    return torch.stack([-1 - start, torch.where(spent == 0, -1, -1 - spent), end], dim=-1)


def pass_times(counters: torch.Tensor) -> tuple:
    """The pass's (list spent, end) in ms after its first block start,
    from :func:`regen_pass`'s ``stats["counters"]`` (spent is None where
    no block found the list spent)."""
    start, spent, end = pass_clocks(counters.cpu()).tolist()
    return None if spent < 0 else (spent - start) / 1e6, (end - start) / 1e6


def regen_pass(tables, config, camera, key: Key, width: int, height: int, spp: int,
               y0: int = 0, n_rows: int = 0, *, stats: Optional[dict] = None,
               order: Optional[torch.Tensor] = None):
    """One regen pass of ``spp`` samples per pixel over image rows [y0,
    y0 + n_rows) (``n_rows=0``: the whole frame) with the ``"megakernel"``
    intersector (``config.chunk_cull`` for the culled instance), over
    ``tables`` (:func:`..render.integrator.scene_tables`): (accum f32[3,
    R], lane_steps i32[R]). On the camera's CUDA device one launch of
    ``csrc/regen_pass.cu``, with no host sync. ``stats``, a dict,
    receives the pass's counters (``"counters"``, i64[len(STATS)] on the
    card, read after the pass), the origin bound (``"omax"``, None where
    the instance stages no spheres) and the grid's blocks (``"grid"``).
    ``order``, i32[R] on the card, a permutation of the band's lanes, is
    the order the work list hands them out in (None: row order); it
    changes the schedule and never the outputs. Only its dtype, shape and
    device are checked (a permutation check would sync with the host): a
    lane it leaves out goes unwritten, one it repeats runs twice, and an
    entry outside [0, R) is undefined behaviour (the kernel reads and
    writes out of bounds). :func:`longest_first` always gives a
    permutation. On the CPU
    :func:`regen_pass_ref`, which takes no ``stats`` and has no list."""
    dev = camera.device
    if tables.rows is not None and tables.rows.device != dev:
        raise ValueError(f"the camera is on {dev}, the tables on {tables.rows.device}")
    if dev.type == "cuda":
        return _regen_pass_cuda(tables, config, camera, key, width, height, spp, y0, n_rows,
                                stats, order)
    if dev.type == "cpu":
        return regen_pass_ref(tables, config, camera, key, width, height, spp, y0, n_rows)
    raise ValueError(f"no regen pass kernel for device {dev}")
