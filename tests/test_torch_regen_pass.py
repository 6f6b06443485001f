"""The regen pass (kernel B1r's function) on the CPU: its plain versions
``ops/regen_pass.py::regen_pass_ref`` (the host loop) and
``regen_pass_scheduled`` (the kernel's schedule: blocks of slots pulling
lanes from the work list, each lane run in its slot from its first step
to its last), and the pieces the kernel takes from them, at 32x24 and
64x48, depth <= 3.

- (a) ``regen_pass_scheduled`` with a few small blocks is bit-equal to
  the host loop as it stood before the pass kernel (transcribed below),
  in fixed and RR mode, at spp 1 and 3, with and without culling, and on
  a row band (``y0 = 8``, ``n_rows = 8``); at 64x48 it equals
  ``regen_pass_ref`` (accum and ``lane_steps``), and so does a schedule
  of one block of a few slots, in which most lanes start many steps
  after the pass.
- (b) At spp = 1 it is bit-equal to the scan (``render_rows_planar``),
  as ``tests/test_regen.py`` holds the JAX package's regen.
- (c) It is held against the JAX package's ``render_regen_planar`` run
  with the Pallas kernel in interpret mode, as
  ``tests/test_torch_regen.py`` runs it, by ``testing.compare_images``
  (99% of pixels within 1e-4, frame means within 1e-3 relative).
- (d) The kernel's camera ray, written out in plain torch in its
  operation order (``camera_rays_ref``), is bit-equal to
  ``Camera.generate_rays_soa`` on the CPU under the CPU's division by
  the image size; where 1/W and 1/H are exact the card's rule (a
  multiply by the f32 reciprocal, what the kernel does) gives the same
  bits too.
- (e) The folded-key table the kernel reads (``pass_keys``) equals
  ``fold_in`` for every stream of a pass, and the kernel's per-lane draw
  (``uniform_lanes``) equals ``stream_uniforms`` element for element.
- (f) The schedule's counters add up: its live lane-steps are the lanes'
  steps, and the lanes' steps stay under the backstop (``spp *
  num_segments + 1``).
- (g) ``origin_bound``, the bound the kernel widens its staged spheres
  for, holds every origin of a pass.
- ``regen_pass_ref``'s ``on_step`` (through which ``chip_smoke.py``
  counts B1r's work for its bound) sees each step's wavefront and
  changes nothing.
- (h) The work list's order: ``longest_first`` is a stable sort of the
  lanes by ``lane_steps >> 5``, longest first; the schedule with an
  order (longest first, reversed) stays bit-equal to the host loop, the
  identity order gives the unordered schedule's counters, and on a frame
  whose long lanes are its bottom rows longest first runs fewer
  block-steps. A Renderer on the CPU keeps row order.
"""

import jax
import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu.models import cornell as jcornell
from montecarlopathtracer_tpu.models import glossy as jglossy
from montecarlopathtracer_tpu.render.integrator import TraceConfig as JTraceConfig
from montecarlopathtracer_tpu.render.regen import render_regen_planar as jax_regen
from montecarlopathtracer_tpu_torch.models import cornell, glossy
from montecarlopathtracer_tpu_torch.ops import regen_pass as RP
from montecarlopathtracer_tpu_torch.ops import rng
from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key
from montecarlopathtracer_tpu_torch.render import regen as REGEN
from montecarlopathtracer_tpu_torch.render.integrator import (
    TraceConfig,
    render_rows_planar,
    scene_tables,
    segment_step,
)
from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
from montecarlopathtracer_tpu_torch.scene.camera import Camera, camera_for_mcrt
from montecarlopathtracer_tpu_torch.testing import (
    cap_torch_threads,
    compare_images,
    plain_kernels,
)
from montecarlopathtracer_tpu_torch.utils import profiling

cap_torch_threads()

W, H = 32, 24
MODES = {
    "fixed": dict(mode="fixed", max_depth=3),
    "rr": dict(mode="rr", rr_depth=1, illum=1.0),
}


@pytest.fixture(scope="module")
def box():
    return cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True, width=W,
                               height=H)


def present_host_loop(scene, camera, key, width, height, spp, config, y0=0, n_rows=0):
    """The port's regen loop as it stood before the pass kernel
    (render/regen.py), the sum of each lane's samples f32[3, R]."""
    n_rows = n_rows or height
    R = width * n_rows
    tables = scene_tables(scene, config)
    lanes = torch.arange(R)
    xs, ys = lanes % width, lanes // width + y0

    def camera_rays(step):
        base = (1 << 30) if step == 0 else (1 << 30) + 2 * step
        jx, jy = rng.stream_uniforms(key, (base, base + 1), R, "cpu") * 2.0 - 1.0
        return camera.generate_rays_soa(xs, ys, jx, jy, width, height)

    pos, dir_ = camera_rays(0)
    pos, dir_ = pos.contiguous(), dir_.contiguous()
    tput, res, accum = torch.ones(3, R), torch.zeros(3, R), torch.zeros(3, R)
    live = torch.ones(R, dtype=torch.bool)
    depth = torch.zeros(R, dtype=torch.int64)
    done = torch.zeros(R, dtype=torch.int64)
    urr = torch.zeros(R)
    rr = config.mode == "rr"
    step = 1
    while step < spp * config.num_segments + 1:
        if (step - 1) % 8 == 0 and not bool(live.any()):
            break
        sid = (step - 1) * 4
        u = rng.stream_uniforms(key, (sid, sid + 1, sid + 3)[:3 if rr else 2], R, "cpu")
        u1, u2 = u[0], u[1]
        if rr:
            urr = u[2]
        npos, ndir, ntput, nres, still = segment_step(
            tables, config, pos, dir_, tput, res, live, u1, u2, urr, config.lane_flags(depth))
        still = still > 0.0
        ended = live & ~still
        accum = accum + torch.where(ended[None, :], nres, 0.0)
        regen = ended & (done + 1 < spp)
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
    return accum


CASES = {
    "fixed_spp1": (MODES["fixed"], 1, {}),
    "fixed_spp3": (MODES["fixed"], 3, {}),
    "rr_spp1": (MODES["rr"], 1, {}),
    "rr_spp3": (MODES["rr"], 3, {}),
    "cull_fixed_spp3": ({**MODES["fixed"], "chunk_cull": True}, 3, {}),
    "cull_rr_spp3": ({**MODES["rr"], "chunk_cull": True}, 3, {}),
    "band_rr_spp3": (MODES["rr"], 3, dict(y0=8, n_rows=8)),
    "band_cull_fixed_spp3": ({**MODES["fixed"], "chunk_cull": True}, 3, dict(y0=8, n_rows=8)),
}


def scheduled(tables, config, camera, key, width, height, spp, **kw):
    """``regen_pass_scheduled`` with three blocks of 32 slots, so that each
    slot runs many lanes one after another."""
    kw = {"blocks": 3, "slots": 32, **kw}
    return RP.regen_pass_scheduled(tables, config, camera, key, width, height, spp, **kw)


@pytest.mark.parametrize("case", CASES)
def test_lane_blocks_are_bit_equal_to_the_present_host_loop(box, case):
    kw, spp, band = CASES[case]
    scene, camera = box
    config = TraceConfig(**kw)
    assert RP.slots_per_block(config) == (128 if config.chunk_cull else 256)
    key = make_key(3)
    want = present_host_loop(scene, camera, key, W, H, spp, config, **band)
    tables = scene_tables(scene, config)
    got, steps, stats = scheduled(tables, config, camera, key, W, H, spp, **band)
    assert torch.equal(got, want)
    _, ref_steps = RP.regen_pass_ref(tables, config, camera, key, W, H, spp, **band)
    assert torch.equal(steps, ref_steps) and steps.dtype == torch.int32
    assert steps.numel() == W * band.get("n_rows", H)
    assert int(stats[RP.STATS.index("blocks")]) == 3
    assert float(want.mean()) > 0.0
    # The entry point on the CPU is the plain whole loop: the same bits.
    assert torch.equal(
        REGEN.render_regen_planar(scene, camera, key, W, H, spp, config, **band),
        (want / float(spp)).reshape(3, band.get("n_rows", H), W))


BIG = {
    "fixed": MODES["fixed"],
    "rr": MODES["rr"],
    "cull_fixed": {**MODES["fixed"], "chunk_cull": True},
    "cull_rr": {**MODES["rr"], "chunk_cull": True},
}


@pytest.fixture(scope="module")
def big_box():
    return cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True, width=64,
                               height=48)


@pytest.mark.parametrize("which", BIG)
def test_scheduled_pass_equals_the_host_loop_at_64x48(big_box, which):
    """The schedule at 64x48 (four blocks of 64 slots): accum and
    lane_steps equal ``regen_pass_ref``'s bit for bit."""
    scene, camera = big_box
    config = TraceConfig(**BIG[which])
    tables, key = scene_tables(scene, config), make_key(23)
    want, want_steps = RP.regen_pass_ref(tables, config, camera, key, 64, 48, 3)
    got, steps, stats = RP.regen_pass_scheduled(tables, config, camera, key, 64, 48, 3,
                                                blocks=4, slots=64)
    assert torch.equal(got, want) and torch.equal(steps, want_steps)
    assert int(stats[RP.STATS.index("live_steps")]) == int(steps.long().sum())


def test_lanes_started_late_are_bit_equal(box):
    """One block of five slots runs the 768 lanes of a 32x24 frame a few
    at a time, so most lanes take their first step long after the pass's
    first and each slot runs ~150 lanes one after another: accum and
    lane_steps are still the host loop's, since a lane's draws and flags
    follow its own step."""
    scene, camera = box
    config = TraceConfig(**MODES["rr"])
    tables, key = scene_tables(scene, config), make_key(24)
    want, want_steps = RP.regen_pass_ref(tables, config, camera, key, W, H, 2)
    got, steps, stats = RP.regen_pass_scheduled(tables, config, camera, key, W, H, 2,
                                                blocks=1, slots=5)
    assert torch.equal(got, want) and torch.equal(steps, want_steps)
    assert int(stats[RP.STATS.index("block_steps")]) > 10 * int(want_steps.max())


@pytest.mark.parametrize("kw", [MODES["fixed"], MODES["rr"],
                                {**MODES["rr"], "chunk_cull": True}],
                         ids=["fixed", "rr", "cull_rr"])
def test_spp1_is_bit_equal_to_the_scan(box, kw):
    scene, camera = box
    config = TraceConfig(**kw)
    key = make_key(8)
    got, _, _ = scheduled(scene_tables(scene, config), config, camera, key, W, H, 1)
    want = render_rows_planar(scene, camera, key, W, H, 0, H, config)
    assert torch.equal(got.reshape(3, H, W), want)


@pytest.mark.parametrize("which", ["cornell_rr", "glossy_cull_rr"])
def test_lane_blocks_match_jax_regen(which):
    w, h, spp = 24, 18, 3
    kw = dict(mode="rr", rr_depth=2, illum=1.0)
    if which == "cornell_rr":
        (js, jcam), (ts, tcam) = jcornell.cornell_box(width=w, height=h), cornell.cornell_box(
            width=w, height=h)
    else:
        kw["chunk_cull"] = True
        (js, jcam), (ts, tcam) = jglossy.glossy_steps(width=w, height=h), glossy.glossy_steps(
            width=w, height=h)
    want = jax_regen(js, jcam, jax.random.key(4), w, h, spp,
                     JTraceConfig(intersector="megakernel", pallas_interpret=True, ray_chunk=0,
                                  **kw))
    config = TraceConfig(**kw)
    got, _, _ = scheduled(scene_tables(ts, config), config, tcam, make_key(4), w, h, spp)
    got = (got / float(spp)).reshape(3, h, w)
    rep = compare_images(got.permute(1, 2, 0).numpy(), np.asarray(want).transpose(1, 2, 0))
    assert rep["ok"], rep
    assert np.asarray(want).mean() > 0.0


@pytest.mark.parametrize("which", ["cornell", "mcrt_band"])
def test_kernel_camera_formula_equals_generate_rays_soa(box, which):
    camera = box[1] if which == "cornell" else camera_for_mcrt(W, H)
    y0 = 0 if which == "cornell" else 8
    R = W * (H - y0)
    lanes = torch.arange(R)
    xs, ys = lanes % W, lanes // W + y0
    u = rng.stream_uniforms(make_key(12), (1 << 30, (1 << 30) + 1), R, "cpu")
    o, d = camera.generate_rays_soa(xs, ys, u[0] * 2.0 - 1.0, u[1] * 2.0 - 1.0, W, H)
    o2, d2 = RP.camera_rays_ref(camera, xs, ys, u[0], u[1], W, H, scalar_div="cpu")
    assert torch.equal(o, o2) and torch.equal(d, d2)
    # 1/32 and 1/16 are exact: there the card's rule gives the same bits.
    o3, d3 = RP.camera_rays_ref(camera, xs, ys, u[0], u[1], W, 16, scalar_div="card")
    o4, d4 = camera.generate_rays_soa(xs, ys, u[0] * 2.0 - 1.0, u[1] * 2.0 - 1.0, W, 16)
    assert torch.equal(o3, o4) and torch.equal(d3, d4)
    with pytest.raises(ValueError, match="scalar_div"):
        RP.camera_rays_ref(camera, xs, ys, u[0], u[1], W, H, scalar_div="tpu")


@pytest.mark.parametrize("kw,spp", [(MODES["fixed"], 3), (dict(mode="rr", rr_depth=5), 32)],
                         ids=["fixed_spp3", "rr5_spp32"])
def test_pass_keys_equal_fold_in_for_every_stream(kw, spp):
    config = TraceConfig(**kw)
    key = fold_in(make_key(21), 5)
    steps = RP.max_steps(spp, config)
    keys, ids = RP.pass_keys(key, steps), RP.stream_ids(steps)
    assert keys.shape == (steps, 5, 2) and keys.dtype == np.uint32
    want_ids = [(1 << 30, (1 << 30) + 1)] + [
        (4 * (s - 1), 4 * (s - 1) + 1, 4 * (s - 1) + 3, (1 << 30) + 2 * s, (1 << 30) + 2 * s + 1)
        for s in range(1, steps)]
    for s in range(steps):
        slots = range(3, 5) if s == 0 else range(5)
        assert tuple(int(ids[s, j]) for j in slots) == want_ids[s]
        for j in slots:
            assert tuple(int(v) for v in keys[s, j]) == fold_in(key, int(ids[s, j]))
    assert not keys[0, :3].any()


def test_uniform_lanes_equal_stream_uniforms():
    """The kernel's per-lane draw (``uniform_lanes``: lane i's own key row
    of ``pass_keys``) equals element i of ``stream_uniforms`` for every
    slot of a few steps, lanes in any order."""
    key, R = make_key(22), 1000
    keys = RP.pass_keys(key, 9)
    ids = RP.stream_ids(9)
    lanes = np.random.default_rng(0).permutation(R)[:300]
    steps = np.random.default_rng(1).integers(1, 9, lanes.size)
    for j in range(5):
        want = torch.stack([rng.stream_uniforms(key, (int(ids[s, j]),), R, "cpu")[0]
                            for s in range(9)])
        got = RP.uniform_lanes(keys[steps, j], lanes)
        assert np.array_equal(got, want[steps, lanes].numpy())


@pytest.mark.parametrize("kw", [{**MODES["rr"], "rr_depth": 2}, {**MODES["fixed"],
                                                                  "chunk_cull": True}],
                         ids=["rr", "cull_fixed"])
def test_block_steps_stay_within_the_whole_loop(box, kw):
    """The schedule's counters: its live lane-steps are the lanes' steps,
    its slot-steps its block-steps times the slots, every block ran; the
    lanes' steps are at least spp, their largest the host loop's last step
    and under the backstop. It refuses a block or slot count below 1."""
    scene, camera = box
    config = TraceConfig(**kw)
    tables, key, spp = scene_tables(scene, config), make_key(30), 3
    _, whole = RP.regen_pass_ref(tables, config, camera, key, W, H, spp)
    _, steps, stats = scheduled(tables, config, camera, key, W, H, spp)
    col = {name: int(stats[i]) for i, name in enumerate(RP.STATS)}
    assert stats.shape == (len(RP.STATS),) and steps.dtype == torch.int32
    assert col["live_steps"] == int(steps.long().sum())
    assert col["slot_steps"] == col["block_steps"] * 32 and col["blocks"] == 3
    assert int(steps.min()) >= spp
    assert int(steps.max()) == int(whole.max()) < RP.max_steps(spp, config)
    for bad in (dict(blocks=0), dict(slots=0)):
        with pytest.raises(ValueError, match="positive"):
            scheduled(tables, config, camera, key, W, H, spp, **bad)


@pytest.mark.parametrize("which", ["cornell_rr", "glossy_fixed"])
def test_origin_bound_holds_every_origin(box, which):
    """``origin_bound`` is at least |o| of every live ray of every step
    of a pass (seen through ``on_step``), and at least |eye|."""
    if which == "cornell_rr":
        scene, camera = box
        config = TraceConfig(**MODES["rr"])
    else:
        scene, camera = glossy.glossy_steps(width=W, height=H)
        config = TraceConfig(**MODES["fixed"], chunk_cull=True)
    tables = scene_tables(scene, config)
    bound = RP.origin_bound(tables, camera.eye, config.eps_offset)
    assert bound.shape == (1,) and bound.dtype == torch.float32
    seen = [float(camera.eye.norm())]

    def on_step(pos, dir_, live):
        seen.append(float(pos.norm(dim=0)[live].max()) if bool(live.any()) else 0.0)

    RP.regen_pass_ref(tables, config, camera, make_key(32), W, H, 3, on_step=on_step)
    assert max(seen) <= float(bound[0]) < 2.0 * max(seen)


def test_plain_kernels_route_the_pass(box):
    scene, camera = box
    config = TraceConfig(**MODES["rr"])
    seen = []
    with plain_kernels():
        assert RP.regen_pass is RP.regen_pass_ref
        ref = RP.regen_pass_ref
        RP.regen_pass = lambda *a, **k: seen.append(1) or ref(*a, **k)
        try:
            img = REGEN.render_regen_planar(scene, camera, make_key(2), W, H, 2, config)
        finally:
            RP.regen_pass = ref
    assert seen == [1] and RP.regen_pass is not RP.regen_pass_ref
    assert torch.equal(img, REGEN.render_regen_planar(scene, camera, make_key(2), W, H, 2,
                                                      config))


def test_on_step_sees_each_steps_wavefront(box):
    """``on_step`` sees the wavefront before each step's segment: the
    first wavefront's camera rays with every lane live, some lane live up
    to the last step that ends a path and none after it. It changes
    nothing."""
    scene, camera = box
    config = TraceConfig(**MODES["rr"])
    tables, key, spp = scene_tables(scene, config), make_key(31), 2
    seen = []

    def on_step(pos, dir_, live):
        seen.append((pos.clone(), dir_.clone(), int(live.sum())))

    accum, steps = RP.regen_pass_ref(tables, config, camera, key, W, H, spp, on_step=on_step)
    want, want_steps = RP.regen_pass_ref(tables, config, camera, key, W, H, spp)
    assert torch.equal(accum, want) and torch.equal(steps, want_steps)
    n = int(steps.max())
    assert len(seen) >= n and seen[0][2] == W * H
    assert all(s[2] > 0 for s in seen[:n]) and all(s[2] == 0 for s in seen[n:])
    lanes = torch.arange(W * H)
    u = rng.stream_uniforms(key, (1 << 30, (1 << 30) + 1), W * H, "cpu")
    pos, dir_ = camera.generate_rays_soa(lanes % W, lanes // W, u[0] * 2.0 - 1.0,
                                         u[1] * 2.0 - 1.0, W, H)
    assert torch.equal(seen[0][0], pos) and torch.equal(seen[0][1], dir_)


@pytest.mark.parametrize("which", ["mixed", "equal", "one_bucket"])
def test_longest_first_sorts_lanes_by_bucket_and_keeps_row_order(which):
    """``longest_first`` is a permutation of the lanes, i32 on the steps'
    device; its buckets (``lane_steps >> 5``) do not increase along the
    list and lanes of one bucket keep their row order; equal lengths, or
    lengths within one bucket, give the identity."""
    R = 5000
    if which == "mixed":
        steps = torch.from_numpy(np.random.default_rng(7).integers(100, 735, R)).int()
        steps[::7] = 100  # many ties, as the misses of a frame
    elif which == "equal":
        steps = torch.full((R,), 300, dtype=torch.int32)
    else:
        steps = torch.from_numpy(np.random.default_rng(8).integers(96, 128, R)).int()
    order = RP.longest_first(steps)
    assert order.dtype == torch.int32 and order.shape == (R,) and order.device == steps.device
    assert torch.equal(order.sort().values, torch.arange(R, dtype=torch.int32))
    buckets = (steps >> 5)[order.long()]
    assert bool((buckets[1:] <= buckets[:-1]).all())
    same = buckets[1:] == buckets[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())
    if which != "mixed":
        assert torch.equal(order, torch.arange(R, dtype=torch.int32))
    else:
        assert int(buckets[0]) == 734 >> 5 and int(buckets[-1]) == 100 >> 5


@pytest.mark.parametrize("how", ["longest_first", "reversed"])
@pytest.mark.parametrize("kw", [MODES["rr"], {**MODES["fixed"], "chunk_cull": True}],
                         ids=["rr", "cull_fixed"])
def test_scheduled_pass_with_an_order_is_bit_equal(box, kw, how):
    """The schedule fetching lanes in an order (longest first by the host
    loop's own ``lane_steps``, or that order reversed) gives the host
    loop's accum and ``lane_steps`` bit for bit."""
    scene, camera = box
    config = TraceConfig(**kw)
    tables, key, spp = scene_tables(scene, config), make_key(33), 16
    want, want_steps = RP.regen_pass_ref(tables, config, camera, key, W, H, spp)
    order = RP.longest_first(want_steps)
    if how == "reversed":
        order = order.flip(0)
    assert not torch.equal(order, torch.arange(W * H, dtype=torch.int32))
    got, steps, stats = scheduled(tables, config, camera, key, W, H, spp, order=order)
    assert torch.equal(got, want) and torch.equal(steps, want_steps)
    assert int(stats[RP.STATS.index("live_steps")]) == int(steps.long().sum())


def test_longest_first_shortens_a_schedule_whose_long_lanes_come_last():
    """The Cornell box seen from below its open front's middle (eye (0, 3,
    26), forward (0, 0.25, -1), 50 degrees) at 16x12, fixed depth 3, 16
    spp: the top rows see past the box (every sample misses, 16 steps),
    the bottom rows its floor and walls (up to 63). Three blocks of 16
    slots, four lanes a slot: longest first (on the host loop's
    ``lane_steps``) runs fewer block-steps than row order, whose last
    lanes are the longest. The identity order gives row order's counters
    exactly; the host loop's accum and steps hold in every order."""
    scene, _ = cornell.cornell_box(width=16, height=12)
    camera = Camera.look((0.0, 3.0, 26.0), (0.0, 0.25, -1.0), (0.0, 1.0, 0.0), width=16,
                         height=12, fov_x_deg=50.0)
    config = TraceConfig(**MODES["fixed"])
    tables, key, spp = scene_tables(scene, config), make_key(3), 16
    want, want_steps = RP.regen_pass_ref(tables, config, camera, key, 16, 12, spp)
    rows = want_steps.reshape(12, 16)
    assert bool((rows[:4] == spp).all()) and int(rows[6:].max()) >= 2 * 32 - 1
    runs = {}
    for name, order in [("rows", None), ("identity", torch.arange(192, dtype=torch.int32)),
                        ("longest_first", RP.longest_first(want_steps))]:
        got, steps, stats = RP.regen_pass_scheduled(tables, config, camera, key, 16, 12, spp,
                                                    blocks=3, slots=16, order=order)
        assert torch.equal(got, want) and torch.equal(steps, want_steps), name
        runs[name] = stats
    assert torch.equal(runs["identity"], runs["rows"])
    block_steps = {k: int(v[RP.STATS.index("block_steps")]) for k, v in runs.items()}
    assert block_steps["longest_first"] < 0.95 * block_steps["rows"], block_steps


def test_scheduled_pass_refuses_a_bad_order(box):
    scene, camera = box
    config = TraceConfig(**MODES["fixed"])
    tables = scene_tables(scene, config)
    for bad in (torch.arange(W * H), torch.arange(W * H - 1, dtype=torch.int32)):
        with pytest.raises(ValueError, match="order"):
            scheduled(tables, config, camera, make_key(0), W, H, 1, order=bad)


def test_a_renderer_on_the_cpu_keeps_row_order(box):
    """The CPU's pass is the host loop, which has no work list: a
    Renderer's history learns nothing there, and no launch counts as
    ordered; a LaneHistory orders only a pass of the shape it learned."""
    scene, camera = box
    settings = RenderSettings(width=W, height=H, spp_per_pass=2, regen=True)
    r = Renderer(scene, camera, TraceConfig(**MODES["rr"]), settings, device="cpu")
    with profiling.recording() as rec:
        r.render(2)
    assert rec["passes"] == 2 and rec["ordered"] == 0
    assert r.lanes.order is None and r.lanes.order_for(r.lanes.shape) is None
    lanes = REGEN.LaneHistory()
    lanes.shape, lanes.order = ("a",), torch.arange(3, dtype=torch.int32)
    assert lanes.order_for(("a",)) is lanes.order and lanes.order_for(("b",)) is None
