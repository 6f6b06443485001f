"""A plain path tracer in PyTorch: the estimator the program computes.

Semantics (those of the reference renderer the program ports):

- a pinhole camera: the ray through pixel (x, y) with jitter (jx, jy) in
  [-1, 1) times ``jitter`` has the direction normalize(right dx + up dy +
  forward), dx = (2 (x + jx) / W - 1) tan_x, dy = (1 - 2 (y + jy) / H)
  tan_y;
- the nearest triangle whose unit-triangle transform accepts the ray (β
  > 0, γ > 0, β + γ < 1, t > 0), ties to the smaller index;
- at a hit: in ``fixed`` mode the path ends on an emitter (any Ka > 0) or
  at depth ``max_depth`` (the gather), adding throughput × Ka × illum;
  in ``rr`` mode Russian roulette from depth ``rr_depth`` on (survive
  with p = max throughput, divide by p) and a hard end at 3 rr_depth; a
  miss ends the path with nothing; otherwise the path scatters:
  refractive materials (Tr > 0) by Schlick's Fresnel, specular ones (Ns
  > 1) by a Blinn half-vector lobe, the rest by a cosine lobe flipped to
  the incoming side, the throughput times Kd, Ks and Kd, the next origin
  the hit point moved ``eps_offset`` along the new direction;
- lanes: a lane holds one pixel and traces ``spp`` samples back to back,
  one segment a step; its draws at step s are element ``pixel`` of the
  streams whose keys are row s of its key table (u1, u2, urr, jitter x,
  jitter y), row 0 holding only the first ray's jitter.

Everything runs in ``dtype`` (float32, or a lower precision for the
control); sums over samples are float64.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import threefry

EPS = 1.19209290e-7  # FLT_EPSILON
TWO_PI = 2.0 * math.pi
JITTER_STREAM = 1 << 30
PAIR_BUDGET = 1 << 25  # lanes x triangles held at once by the intersection
BLOCK = 1 << 20  # lanes traced together: each step costs its launches more than its lanes


@dataclasses.dataclass
class Scene:
    """The scene as the reference reads it, on one device."""

    m: torch.Tensor  # [T, 3, 3] world -> unit-triangle frame
    m_a: torch.Tensor  # [T, 3] m @ a
    n: torch.Tensor  # [T, 3, 3] corner normals (corner, xyz)
    mat: torch.Tensor  # i64[T]
    ka: torch.Tensor  # [M, 3]
    kd: torch.Tensor
    ks: torch.Tensor
    ns: torch.Tensor  # [M]
    tr: torch.Tensor
    ni: torch.Tensor
    lo: torch.Tensor  # f32[T, 3] the triangles' boxes
    hi: torch.Tensor

    @property
    def num_triangles(self) -> int:
        return int(self.mat.shape[0])


def prepare_scene(arrays, device, dtype=torch.float32, tables=None) -> Scene:
    """The reference's scene from the benchmark's arrays
    (:class:`perfbench.scenes.assemble.Arrays`): each transform inverted
    in float64 and rounded to ``dtype`` (the transforms and normals
    first to ``tables``, where given: stored in a lower precision)."""
    a, b, c = (x.astype(np.float64) for x in arrays.corners())
    e1, e2 = b - a, c - a
    nrm = np.cross(e1, e2)
    E = np.stack([e1, e2, nrm], axis=-1)  # columns
    det = np.linalg.det(E)
    ok = np.abs(det) > 1e-30
    E[~ok] = np.eye(3)
    m = np.linalg.inv(E)
    m[~ok] = 0.0  # a degenerate triangle accepts no ray
    m_a = np.einsum("tij,tj->ti", m, a)
    corners = np.stack([arrays.normals[arrays.tri_n[:, k]] for k in range(3)], axis=1)
    lo = np.minimum(np.minimum(a, b), c).astype(np.float32)
    hi = np.maximum(np.maximum(a, b), c).astype(np.float32)

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dt)

    def stored(x):
        return t(x, tables or dtype).to(dtype)

    return Scene(m=stored(m), m_a=stored(m_a), n=stored(corners), mat=t(arrays.tri_mat, torch.int64),
                 ka=t(arrays.mat_ka), kd=t(arrays.mat_kd), ks=t(arrays.mat_ks),
                 ns=t(arrays.mat_ns), tr=t(arrays.mat_tr), ni=t(arrays.mat_ni),
                 lo=t(lo, torch.float32), hi=t(hi, torch.float32))


@dataclasses.dataclass
class Camera:
    eye: torch.Tensor  # [3]
    right: torch.Tensor
    up: torch.Tensor
    forward: torch.Tensor
    tan_x: torch.Tensor  # []
    tan_y: torch.Tensor
    jitter: float
    width: int
    height: int


def make_camera(spec: dict, width: int, height: int, device, dtype=torch.float32) -> Camera:
    """The camera of a configuration's ``camera`` entry: eye, forward, up,
    horizontal field of view ``fov_x_deg``, jitter in pixels. The basis is
    right = forward x up, up = right x forward, in float32."""
    f32 = np.float32
    fwd = np.asarray(spec["forward"], f32)
    fwd = fwd / np.sqrt(np.sum(fwd * fwd, dtype=f32))
    right = np.cross(fwd, np.asarray(spec["up"], f32)).astype(f32)
    right = right / np.sqrt(np.sum(right * right, dtype=f32))
    up = np.cross(right, fwd).astype(f32)
    up = up / np.sqrt(np.sum(up * up, dtype=f32))
    tan_x = f32(math.tan(math.radians(spec["fov_x_deg"]) / 2.0))
    tan_y = f32(tan_x * f32(height / width))

    def t(x):
        return torch.as_tensor(np.asarray(x, f32), device=device).to(dtype)

    return Camera(eye=t(spec["eye"]), right=t(right), up=t(up), forward=t(fwd), tan_x=t(tan_x),
                  tan_y=t(tan_y), jitter=float(spec["jitter"]), width=width, height=height)


@dataclasses.dataclass(frozen=True)
class Estimator:
    mode: str  # "fixed" or "rr"
    max_depth: int = 7
    rr_depth: int = 5
    illum: float = 10.0
    eps_offset: float = 0.01

    @property
    def num_segments(self) -> int:
        return self.max_depth + 1 if self.mode == "fixed" else 3 * self.rr_depth + 1

    def max_steps(self, spp: int) -> int:
        return spp * self.num_segments + 1


def stream_ids(steps: int) -> np.ndarray:
    """i64[steps, 5]: the streams of a lane's step s >= 1: 4(s-1), 4(s-1)+1,
    4(s-1)+3, and the jitter of a ray started after it, 2^30 + 2s, 2^30 +
    2s + 1; row 0: the first ray's jitter, 2^30 and 2^30 + 1."""
    ids = np.zeros((steps, 5), np.int64)
    s = np.arange(1, steps)
    ids[1:, 0], ids[1:, 1], ids[1:, 2] = 4 * (s - 1), 4 * (s - 1) + 1, 4 * (s - 1) + 3
    ids[0, 3:] = (JITTER_STREAM, JITTER_STREAM + 1)
    ids[1:, 3], ids[1:, 4] = JITTER_STREAM + 2 * s, JITTER_STREAM + 2 * s + 1
    return ids


def key_tables(keys: np.ndarray, steps: int) -> np.ndarray:
    """The key tables of lanes drawn under ``keys`` u32[G, 2]: u32[G,
    steps, 5, 2]."""
    ids = stream_ids(steps)
    return threefry.fold_in(keys[:, None, None, :], ids[None])


# ----------------------------------------------------------------- geometry

def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def normalize3(v):
    return v / torch.sqrt(torch.clamp_min(dot3(v, v), EPS * EPS))


def sqrt_nonneg(x):
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def camera_rays(cam: Camera, pixels, ux, uy):
    """Origins and unit directions [3, n] of pixels i64[n] under uniforms."""
    dt = cam.eye.dtype
    xs = (pixels % cam.width).to(dt)
    ys = (pixels // cam.width).to(dt)
    bx = xs + (ux * 2.0 - 1.0) * cam.jitter
    by = ys + (uy * 2.0 - 1.0) * cam.jitter
    dx = (2.0 * bx / cam.width - 1.0) * cam.tan_x
    dy = (1.0 - 2.0 * by / cam.height) * cam.tan_y
    c = torch.stack([(cam.right[k] * dx + cam.up[k] * dy) + cam.forward[k] for k in range(3)])
    d = c / torch.sqrt((c[0] * c[0] + c[1] * c[1]) + c[2] * c[2])
    return cam.eye[:, None].expand(d.shape).clone(), d


def intersect(scene: Scene, o, d):
    """Nearest accepted triangle of rays [3, n]: (hit bool[n], t, β, γ
    [n], index i64[n]; t, β, γ are 0 and the index 0 on a miss)."""
    T = scene.num_triangles
    n = o.shape[1]
    step = max(1, PAIR_BUDGET // max(T, 1))
    cols = torch.arange(T, device=o.device)
    m, ma = scene.m, scene.m_a
    out = []
    for s in range(0, n, step):
        oo, dd = o[:, s:s + step, None], d[:, s:s + step, None]

        def frame(k):
            op = m[:, k, 0] * oo[0] + m[:, k, 1] * oo[1] + m[:, k, 2] * oo[2] - ma[:, k]
            dp = m[:, k, 0] * dd[0] + m[:, k, 1] * dd[1] + m[:, k, 2] * dd[2]
            return op, dp

        ox, dx = frame(0)
        oy, dy = frame(1)
        oz, dz = frame(2)
        t = -oz / dz
        beta = ox + t * dx
        gamma = oy + t * dy
        ok = (beta > 0.0) & (gamma > 0.0) & (t > 0.0) & (beta + gamma < 1.0)
        tm = torch.where(ok, t, math.inf)
        best = tm.amin(dim=1)
        hit = best < math.inf
        idx = torch.where(hit[:, None] & (tm == best[:, None]), cols, T).amin(dim=1)
        idx = torch.where(hit, idx, 0)
        g = idx[:, None]
        out.append((hit, torch.where(hit, best, 0.0), torch.where(hit, beta.gather(1, g)[:, 0], 0.0),
                    torch.where(hit, gamma.gather(1, g)[:, 0], 0.0), idx))
    return tuple(torch.cat(x) for x in zip(*out))


def boxes_reached(scene: Scene, o, d, t_hit, hit, idx) -> torch.Tensor:
    """For rays [3, n] (float32), the triangles whose bounding box each
    ray enters before its hit (at any t >= 0 for a miss), the hit
    triangle's own included: i64[n]."""
    T = scene.num_triangles
    n = o.shape[1]
    step = max(1, PAIR_BUDGET // max(T, 1))
    lo, hi = scene.lo, scene.hi
    out = []
    for s in range(0, n, step):
        oo, dd = o[:, s:s + step].float(), d[:, s:s + step].float()
        far = torch.where(hit[s:s + step], t_hit[s:s + step].float(), math.inf)[:, None]
        tmin = torch.full((oo.shape[1], T), -math.inf, device=o.device)
        tmax = torch.full((oo.shape[1], T), math.inf, device=o.device)
        for k in range(3):
            ok, dk = oo[k][:, None], dd[k][:, None]
            flat = dk == 0.0
            inv = 1.0 / torch.where(flat, 1.0, dk)
            t0 = (lo[:, k] - ok) * inv
            t1 = (hi[:, k] - ok) * inv
            inside = (lo[:, k] <= ok) & (ok <= hi[:, k])
            near = torch.where(flat, torch.where(inside, -math.inf, math.inf), torch.minimum(t0, t1))
            away = torch.where(flat, torch.where(inside, math.inf, -math.inf),
                               torch.maximum(t0, t1))
            tmin = torch.maximum(tmin, near)
            tmax = torch.minimum(tmax, away)
        reached = (tmin <= tmax) & (tmax >= 0.0) & (tmin <= far)
        own = torch.zeros_like(reached)
        own[torch.arange(own.shape[0], device=o.device), idx[s:s + step]] = True
        reached |= own & hit[s:s + step, None]
        out.append(reached.sum(dim=1))
    return torch.cat(out)


# ----------------------------------------------------------------- samplers

def rotate_to_frame(local, normal):
    nx, ny, nz = normal[0], normal[1], normal[2]
    dx, dy, dz = local[0], local[1], local[2]
    s2 = torch.clamp_min(1.0 - ny * ny, EPS * EPS)
    inv_len = 1.0 / torch.sqrt(s2)
    length = torch.sqrt(s2)
    rotated = torch.stack([(nz * dx + nx * ny * dz) * inv_len + nx * dy,
                           ny * dy - dz * length,
                           (-nx * dx + nz * ny * dz) * inv_len + nz * dy])
    out = torch.where((torch.abs(ny - 1.0) < EPS)[None, :], local, rotated)
    return torch.where((torch.abs(ny + 1.0) < EPS)[None, :], -local, out)


def sample_cosine(u1, u2, normal):
    sin_t = torch.sqrt(u1)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    phi = TWO_PI * u2
    return rotate_to_frame(torch.stack([sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi)]),
                           normal)


def sample_blinn(u1, u2, normal, indir, ns):
    cos_t = torch.pow(torch.clamp_min(u1, 1e-30), 1.0 / (ns + 1.0))
    sin_t = sqrt_nonneg(1.0 - cos_t * cos_t)
    phi = TWO_PI * u2
    half = rotate_to_frame(torch.stack([sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi)]),
                           normal)
    return indir - half * (2.0 * dot3(indir, half))[None, :]


def sample_fresnel(u, normal, indir, tr, ni):
    ndoti = dot3(indir, normal)
    refract = u < tr * (1.0 - torch.pow(1.0 - torch.abs(ndoti), 5.0))
    entering = ndoti <= 0.0
    in_alpha = -ndoti / ni - sqrt_nonneg(1.0 - (1.0 - ndoti * ndoti) / (ni * ni))
    d_in = normalize3(normal * in_alpha[None, :] + indir / ni[None, :])
    test = 1.0 - (1.0 - ndoti * ndoti) * ni * ni
    d_out = normalize3(normal * (-ndoti * ni + sqrt_nonneg(test))[None, :] + indir * ni[None, :])
    d_mirror = indir - normal * (2.0 * dot3(indir, normal))[None, :]
    d_refract = torch.where(entering[None, :], d_in,
                            torch.where((test < 0.0)[None, :], d_mirror, d_out))
    return torch.where(refract[None, :], d_refract, d_mirror)


# ----------------------------------------------------------------- segment

def segment(scene: Scene, est: Estimator, pos, dir_, tput, depth, u1, u2, urr, *, reach=None):
    """One segment of live paths: (new pos, dir, tput [3, n], emitted
    radiance [3, n], still bool[n]). ``reach``, a dict, gains the boxes
    the segments reached, by depth."""
    hit, t, beta, gamma, idx = intersect(scene, pos, dir_)
    if reach is not None:
        got = boxes_reached(scene, pos, dir_, t, hit, idx)
        for k in torch.unique(depth).tolist():
            reach[k] = reach.get(k, 0) + int(got[depth == k].sum())
    mat = scene.mat[idx]
    ka, kd, ks = scene.ka[mat].T, scene.kd[mat].T, scene.ks[mat].T
    ns, tr, ni = scene.ns[mat], scene.tr[mat], scene.ni[mat]
    is_emit = hit & (ka > 0.0).any(dim=0)
    tp = tput
    if est.mode == "rr":
        do_rr = (depth >= est.rr_depth) & (depth < 3 * est.rr_depth)
        p = torch.maximum(torch.maximum(tput[0], tput[1]), tput[2])
        survive = p > urr
        tp = torch.where((do_rr & survive)[None, :], tput / torch.clamp_min(p, 1e-20)[None, :],
                         tput)
        dead = ~hit | (do_rr & ~survive) | (depth >= 3 * est.rr_depth)
        emit = ~dead & is_emit
    else:
        dead = ~hit
        emit = ~dead & (is_emit | (depth == est.max_depth))
    res = torch.where(emit[None, :], tp * ka * est.illum, 0.0)
    still = ~dead & ~emit

    w0 = 1.0 - beta - gamma
    cn = scene.n[idx]  # [n, 3 corners, 3]
    nrm = torch.stack([cn[:, 0, k] * w0 + cn[:, 1, k] * beta + cn[:, 2, k] * gamma
                       for k in range(3)])
    normal = normalize3(nrm)
    refr = tr > 0.0
    spec = ~refr & (ns > 1.0)
    d_f = sample_fresnel(u1, normal, dir_, tr, ni)
    d_p = sample_blinn(u1, u2, normal, dir_, ns)
    d_h = sample_cosine(u1, u2, normal)
    d_d = torch.where((dot3(dir_, normal) > 0.0)[None, :], -d_h, d_h)
    new_dir = torch.where(refr[None, :], d_f, torch.where(spec[None, :], d_p, d_d))
    albedo = torch.where(spec[None, :], ks, kd)
    new_tput = tp * albedo
    new_pos = (pos + t[None, :] * dir_) + new_dir * est.eps_offset
    return new_pos, new_dir, new_tput, res, still


# ----------------------------------------------------------------- lanes

def run_lanes(scene: Scene, cam: Camera, est: Estimator, pixels: torch.Tensor,
              tables: torch.Tensor, group: torch.Tensor, spp: int, *,
              reach: Optional[dict] = None, block: int = 1 << 16):
    """Trace lanes: lane i holds pixel ``pixels[i]`` and draws under key
    table ``tables[group[i]]`` (i64[G, steps, 5, 2] on the device), in
    blocks of ``block`` lanes. Returns each lane's sum of its ``spp``
    samples, f64[3, n]."""
    dev = pixels.device
    n = pixels.shape[0]
    total = torch.zeros(3, n, dtype=torch.float64, device=dev)
    for s in range(0, n, block):
        total[:, s:s + block] = _run_block(scene, cam, est, pixels[s:s + block], tables,
                                           group[s:s + block], spp, reach)
    return total


def _draw(tables, group, step, lanes, pixels, slots):
    """Uniforms [len(slots), n] of the lanes ``lanes`` at their step."""
    keys = tables[group[lanes], step[lanes]][:, list(slots)]  # [n, k, 2]
    k = keys.shape[1]
    u = threefry.uniform_lanes(keys.reshape(-1, 2), pixels[lanes].repeat_interleave(k))
    return u.reshape(-1, k).T


def _run_block(scene, cam, est, pixels, tables, group, spp, reach):
    dev = pixels.device
    dt = cam.eye.dtype
    n = pixels.shape[0]
    steps_cap = tables.shape[1]
    step = torch.zeros(n, dtype=torch.int64, device=dev)
    all_lanes = torch.arange(n, device=dev)
    u = _draw(tables, group, step, all_lanes, pixels, (3, 4))
    pos, dir_ = camera_rays(cam, pixels, u[0].to(dt), u[1].to(dt))
    tput = torch.ones(3, n, dtype=dt, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    done = torch.zeros(n, dtype=torch.int64, device=dev)
    accum = torch.zeros(3, n, dtype=torch.float64, device=dev)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    step += 1
    while True:
        lanes = torch.nonzero(live).flatten()
        if lanes.numel() == 0:
            break
        if int(step[lanes[0]]) >= steps_cap:
            raise RuntimeError("a lane passed its key table")
        u = _draw(tables, group, step, lanes, pixels, (0, 1, 2) if est.mode == "rr" else (0, 1))
        urr = u[2].to(dt) if est.mode == "rr" else None
        npos, ndir, ntput, res, still = segment(
            scene, est, pos[:, lanes], dir_[:, lanes], tput[:, lanes], depth[lanes],
            u[0].to(dt), u[1].to(dt), urr, reach=reach)
        ended = ~still
        accum[:, lanes] += torch.where(ended[None, :], res.double(), 0.0)
        done[lanes] += ended.long()
        again = ended & (done[lanes] < spp)
        finished = ended & ~again
        cont = lanes[still]
        pos[:, cont], dir_[:, cont], tput[:, cont] = npos[:, still], ndir[:, still], ntput[:, still]
        depth[cont] += 1
        restart = lanes[again]
        if restart.numel():
            u = _draw(tables, group, step, restart, pixels, (3, 4))
            p, d = camera_rays(cam, pixels[restart], u[0].to(dt), u[1].to(dt))
            pos[:, restart], dir_[:, restart] = p, d
            tput[:, restart] = 1.0
            depth[restart] = 0
        live[lanes[finished]] = False
        step[lanes] += 1
    return accum

