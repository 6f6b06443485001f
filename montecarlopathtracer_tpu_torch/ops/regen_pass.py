"""A whole pass of the regenerating wavefront (kernel B1r) and its plain
version.

The counterpart of the JAX package's regen device program
(``montecarlopathtracer_tpu/render/regen.py``: a ``lax.while_loop`` under
``jit`` over the per-lane-flag segment kernel, with the bookkeeping fused
around it by XLA). Lane ``i`` is pinned to pixel ``i`` of the band
[y0, y0 + n_rows) and traces that pixel's ``spp`` samples back to back;
see :mod:`..render.regen` for the estimator and its stream ids.

- :func:`regen_pass` is the entry point. For a CUDA device it launches
  ``csrc/regen_pass.cu`` once (adding one to ``regen_pass.launches``, or
  to ``regen_pass.cull_launches`` for the culled instance): each block of
  256 lanes (128 with ``chunk_cull``) runs the loop for its own lanes
  until none is live, its draws, flags, segment (B1l's selection loop and
  epilogue), bookkeeping and camera rays inside the kernel, with no host
  step. For the CPU it runs :func:`regen_pass_ref`. It never falls back
  from one to the other: a build or launch failure raises.
- :func:`regen_pass_ref` is the host loop: one whole segment per step
  through :func:`..render.integrator.segment_step` (B1l on the card, its
  plain version on the CPU or under ``testing.plain_kernels()``), with
  the live mask read every :data:`LIVE_CHECK_EVERY` steps. With
  ``lane_block`` it runs each block of that many lanes as its own loop
  that stops when the block's lanes are done, as the kernel's blocks do.
  It also serves the traversal path, which has no pass kernel: there each
  step launches B5 and B6l.
- :func:`pass_keys` folds every stream key of a pass on the host (the
  table the kernel reads); :func:`camera_rays_ref` is the kernel's camera
  ray in plain torch, in its operation order.

Both return ``(accum f32[3, R], steps i32[blocks])``: the sum of each
lane's samples (the caller divides by ``spp``) and the steps each block
ran, the step at which its last path ended (``spp * num_segments + 1``
if the backstop stopped it with a lane live, which cannot happen: every
path ends within ``num_segments`` segments).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import numpy as np
import torch

from . import cuda_build
from . import rng
from .rng import Key

LIVE_CHECK_EVERY = 8  # host-loop steps between two reads of the live mask
LANE_BLOCK = 256  # lanes of a block of the kernel (csrc/sphere_select.cuh kSelRays)
CULL_LANE_BLOCK = 128  # with chunk_cull (2 * kCullThreads)
_KEY_SLOTS = 5  # a step's streams: u1, u2, urr, jitter x, jitter y
_M32 = 0xFFFFFFFF
_JITTER = 1 << 30  # first jitter stream


def lane_block(config) -> int:
    """Lanes per block of the kernel for ``config``."""
    return CULL_LANE_BLOCK if config.chunk_cull else LANE_BLOCK


def max_steps(spp: int, config) -> int:
    """The loop's backstop: ``spp * num_segments + 1`` (every path ends
    within ``num_segments`` segments, so the steps stay below it)."""
    return spp * config.num_segments + 1


def fold_in_many(key: Key, data: np.ndarray):
    """:func:`.rng.fold_in` of every entry of ``data`` (uint32-valued) at
    once, on numpy uint32 arrays: (k0, k1) uint32 arrays."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = np.full(data.shape, ks[0], np.uint32)
    x1 = (np.asarray(data, np.uint64) + ks[1]).astype(np.uint32)  # wraps mod 2**32
    for i in range(5):
        for r in rng._ROT[i % 2]:
            x0 += x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 ^= x0
        x0 += np.uint32(ks[(i + 1) % 3])
        x1 += np.uint32((ks[(i + 2) % 3] + i + 1) & _M32)
    return x0, x1


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


# ---------------------------------------------------------------- plain version

def _band(width, height, n_rows):
    n_rows = n_rows or height
    return n_rows, width * n_rows


def _loop(tables, config, camera, key, width, height, spp, y0, R, lo, hi, check_every,
          on_step=None):
    """The host loop over lanes [lo, hi) of a band of R lanes: (accum
    f32[3, hi - lo], steps i64[]). Every stream draws R values, of which
    the lanes take theirs. ``on_step(pos, dir_, live)`` sees each step's
    wavefront before its segment."""
    from ..render.integrator import segment_step

    dev = camera.device
    whole = (lo, hi) == (0, R)
    lanes = torch.arange(lo, hi, device=dev)
    xs = lanes % width
    ys = lanes // width + y0

    def draw(ids):
        u = rng.stream_uniforms(key, ids, R, dev)
        return u if whole else u[:, lo:hi]

    def camera_rays(step):
        base = _JITTER if step == 0 else _JITTER + 2 * step
        jx, jy = draw((base, base + 1)) * 2.0 - 1.0
        return camera.generate_rays_soa(xs, ys, jx, jy, width, height)

    n = hi - lo
    pos, dir_ = camera_rays(0)
    pos, dir_ = pos.contiguous(), dir_.contiguous()
    tput = torch.ones(3, n, device=dev)
    res = torch.zeros(3, n, device=dev)
    accum = torch.zeros(3, n, device=dev)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)  # within the current path
    done = torch.zeros(n, dtype=torch.int64, device=dev)  # samples completed
    last = torch.zeros(n, dtype=torch.int64, device=dev)  # the step its last path ended
    urr = torch.zeros(n, device=dev)
    rr = config.mode == "rr"
    stop = max_steps(spp, config)
    step = 1  # the segment at depth step - 1 when spp = 1
    while step < stop:
        if (step - 1) % check_every == 0 and not bool(live.any()):
            break
        sid = (step - 1) * 4
        u = draw((sid, sid + 1, sid + 3)[:3 if rr else 2])
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
    return accum, torch.where(live.any(), stop, last.max())


def regen_pass_ref(tables, config, camera, key: Key, width: int, height: int, spp: int,
                   y0: int = 0, n_rows: int = 0, lane_block: Optional[int] = None,
                   on_step: Optional[Callable] = None):
    """Plain version of :func:`regen_pass` (see the module docstring): the
    host loop over one whole segment per step. ``lane_block`` None runs
    all lanes in one loop (one entry of ``steps``); an int runs each block
    of that many lanes as its own loop that checks its live mask every
    step, as the kernel's blocks do (256 lanes, 128 with culling).
    ``on_step(pos, dir_, live)``, with ``lane_block`` None, is called with
    each step's wavefront f32[3, R], f32[3, R], bool[R] before its
    segment: a measurement of the pass's work sees the rays each step
    traces."""
    _, R = _band(width, height, n_rows)
    if lane_block is None:
        accum, steps = _loop(tables, config, camera, key, width, height, spp, y0, R, 0, R,
                             LIVE_CHECK_EVERY, on_step)
        return accum, steps.reshape(1).to(torch.int32)
    if on_step is not None:
        raise ValueError("on_step sees the whole band's wavefront: lane_block must be None")
    if lane_block < 1:
        raise ValueError(f"lane_block must be positive, got {lane_block}")
    accum = torch.empty(3, R, device=camera.device)
    steps = []
    for lo in range(0, R, lane_block):
        hi = min(lo + lane_block, R)
        accum[:, lo:hi], s = _loop(tables, config, camera, key, width, height, spp, y0, R, lo,
                                   hi, 1)
        steps.append(s)
    return accum, torch.stack(steps).to(torch.int32)


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


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("regen_pass")
    fn = lib.regen_pass_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [_P, _P, _P, _P, _P, ctypes.c_int,  # rows, clo, chi, cslack, rec, cull
                   _P, _P, _P,  # keys, cam, args
                   _P, _P, _P, _P]  # state, accum, steps, stream
    lib.regen_pass_blocks.restype = ctypes.c_int
    lib.regen_pass_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


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


def _check_band(width, height, y0, n_rows, spp):
    if width < 1 or height < 1 or not 0 <= y0 or y0 + n_rows > height:
        raise ValueError(f"rows [{y0}, {y0 + n_rows}) of a {width}x{height} frame")
    if spp < 1:
        raise ValueError(f"spp must be at least 1, got {spp}")
    if width * n_rows >= 2**31:
        raise ValueError("the band's lanes must fit in int32")


def _regen_pass_cuda(tables, config, camera, key, width, height, spp, y0, n_rows):
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
    cull = config.chunk_cull
    boxes = (None,) * 4
    if cull:
        F.check_chunk_boxes(rows, tables.clo, tables.chi, tables.cslack)
        crec = tables.crec if tables.crec is not None else CU.cull_records(rows)
        CU.check_records(crec, rows)
        boxes = (tables.clo.data_ptr(), tables.chi.data_ptr(), tables.cslack.data_ptr(),
                 crec.data_ptr())
    lib = _lib()
    keys = _keys_on(dev, pass_keys(key, max_steps(spp, config)))
    cam = camera_table(camera)
    args = _args(config, camera, R, rows.shape[0], width, height, y0, spp)
    state = torch.empty(4, 3, R, device=dev)
    accum = torch.empty(3, R, device=dev)
    steps = torch.empty(lib.regen_pass_blocks(R, int(cull)), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.regen_pass_launch(rows.data_ptr(), *boxes, int(cull), keys.data_ptr(),
                                    cam.data_ptr(), ctypes.byref(args), state.data_ptr(),
                                    accum.data_ptr(), steps.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"regen_pass kernel launch failed: cudaError {err}")
    if cull:
        regen_pass.cull_launches += 1
    else:
        regen_pass.launches += 1
    return accum, steps


def regen_pass(tables, config, camera, key: Key, width: int, height: int, spp: int,
               y0: int = 0, n_rows: int = 0):
    """One regen pass of ``spp`` samples per pixel over image rows [y0,
    y0 + n_rows) (``n_rows=0``: the whole frame) with the ``"megakernel"``
    intersector (``config.chunk_cull`` for the culled instance), over
    ``tables`` (:func:`..render.integrator.scene_tables`): (accum f32[3,
    R], steps i32[blocks]). On the camera's CUDA device one launch of
    ``csrc/regen_pass.cu``; on the CPU :func:`regen_pass_ref` (steps of
    one block)."""
    dev = camera.device
    if tables.rows is not None and tables.rows.device != dev:
        raise ValueError(f"the camera is on {dev}, the tables on {tables.rows.device}")
    if dev.type == "cuda":
        return _regen_pass_cuda(tables, config, camera, key, width, height, spp, y0, n_rows)
    if dev.type == "cpu":
        return regen_pass_ref(tables, config, camera, key, width, height, spp, y0, n_rows)
    raise ValueError(f"no regen pass kernel for device {dev}")


regen_pass.launches = 0  # launches of the plain instance (B1r)
regen_pass.cull_launches = 0  # launches of the culled instance (B1rc)
