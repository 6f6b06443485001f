"""The regen pass (kernel B1r's function) on the CPU: its plain version
``ops/regen_pass.py::regen_pass_ref`` and the pieces the kernel takes
from it, at 32x24 and depth <= 3.

- (a) ``regen_pass_ref`` with the kernel's lane blocks (256 lanes, 128
  with ``chunk_cull``), each block its own loop that stops when its
  lanes are done, is bit-equal to the host loop as it stood before the
  pass kernel (transcribed below), in fixed and RR mode, at spp 1 and 3,
  with and without culling, and on a row band (``y0 = 8``,
  ``n_rows = 8``).
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
  ``fold_in`` for every stream of a pass.
- (f) Each block's steps are at most the whole loop's, the longest equal
  to it, and the backstop (``spp * num_segments + 1``) is never reached.
- ``regen_pass_ref``'s ``on_step`` (through which ``chip_smoke.py``
  counts B1r's work for its bound) sees each step's wavefront and
  changes nothing.
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
from montecarlopathtracer_tpu_torch.scene.camera import camera_for_mcrt
from montecarlopathtracer_tpu_torch.testing import (
    cap_torch_threads,
    compare_images,
    plain_kernels,
)

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


@pytest.mark.parametrize("case", CASES)
def test_lane_blocks_are_bit_equal_to_the_present_host_loop(box, case):
    kw, spp, band = CASES[case]
    scene, camera = box
    config = TraceConfig(**kw)
    block = RP.lane_block(config)
    assert block == (128 if config.chunk_cull else 256)
    key = make_key(3)
    want = present_host_loop(scene, camera, key, W, H, spp, config, **band)
    got, steps = RP.regen_pass_ref(scene_tables(scene, config), config, camera, key, W, H, spp,
                                   lane_block=block, **band)
    assert torch.equal(got, want)
    assert steps.numel() == -(-W * band.get("n_rows", H) // block)
    assert float(want.mean()) > 0.0
    # The entry point on the CPU is the plain whole loop: the same bits.
    assert torch.equal(
        REGEN.render_regen_planar(scene, camera, key, W, H, spp, config, **band),
        (want / float(spp)).reshape(3, band.get("n_rows", H), W))


@pytest.mark.parametrize("kw", [MODES["fixed"], MODES["rr"],
                                {**MODES["rr"], "chunk_cull": True}],
                         ids=["fixed", "rr", "cull_rr"])
def test_spp1_is_bit_equal_to_the_scan(box, kw):
    scene, camera = box
    config = TraceConfig(**kw)
    key = make_key(8)
    got, _ = RP.regen_pass_ref(scene_tables(scene, config), config, camera, key, W, H, 1,
                               lane_block=RP.lane_block(config))
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
    got, _ = RP.regen_pass_ref(scene_tables(ts, config), config, tcam, make_key(4), w, h, spp,
                               lane_block=RP.lane_block(config))
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


@pytest.mark.parametrize("kw", [{**MODES["rr"], "rr_depth": 2}, {**MODES["fixed"],
                                                                  "chunk_cull": True}],
                         ids=["rr", "cull_fixed"])
def test_block_steps_stay_within_the_whole_loop(box, kw):
    scene, camera = box
    config = TraceConfig(**kw)
    tables, key, spp = scene_tables(scene, config), make_key(30), 3
    _, whole = RP.regen_pass_ref(tables, config, camera, key, W, H, spp)
    _, blocks = RP.regen_pass_ref(tables, config, camera, key, W, H, spp,
                                  lane_block=RP.lane_block(config))
    assert whole.shape == (1,) and blocks.dtype == torch.int32
    assert int(blocks.max()) == int(whole[0]) and bool((blocks <= whole).all())
    assert int(whole[0]) < RP.max_steps(spp, config)
    assert int(blocks.min()) >= 1


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
    nothing, and it refuses lane blocks (it sees the whole band)."""
    scene, camera = box
    config = TraceConfig(**MODES["rr"])
    tables, key, spp = scene_tables(scene, config), make_key(31), 2
    seen = []

    def on_step(pos, dir_, live):
        seen.append((pos.clone(), dir_.clone(), int(live.sum())))

    accum, steps = RP.regen_pass_ref(tables, config, camera, key, W, H, spp, on_step=on_step)
    want, want_steps = RP.regen_pass_ref(tables, config, camera, key, W, H, spp)
    assert torch.equal(accum, want) and torch.equal(steps, want_steps)
    n = int(steps[0])
    assert len(seen) >= n and seen[0][2] == W * H
    assert all(s[2] > 0 for s in seen[:n]) and all(s[2] == 0 for s in seen[n:])
    lanes = torch.arange(W * H)
    u = rng.stream_uniforms(key, (1 << 30, (1 << 30) + 1), W * H, "cpu")
    pos, dir_ = camera.generate_rays_soa(lanes % W, lanes // W, u[0] * 2.0 - 1.0,
                                         u[1] * 2.0 - 1.0, W, H)
    assert torch.equal(seen[0][0], pos) and torch.equal(seen[0][1], dir_)
    with pytest.raises(ValueError, match="lane_block"):
        RP.regen_pass_ref(tables, config, camera, key, W, H, spp, lane_block=256,
                          on_step=on_step)
