"""smallpt's scene (``perfbench/configs/smallpt.json`` and the port's
``models/smallpt.py``) against the numbers of ``smallpt.cpp``, its camera
against smallpt's, the CLI's automatic choices for its cell, the port's
culled RR regen film against the plain reference
(``perfbench/reference/tracer.py``) at 32x24, and ``--scene smallpt``
through the CLI. On the card: a culled pass's record holds the table's
chunks and the culled tables' span; the culled pass kernel B1rc's
film and lane steps are bit-equal to the host loop's on a pass that its
pair path takes most leaves of (smallpt, RR) and on one that its
per-lane path does (the glossy stage's primary rays), with its leaf
counters. The reader of ``b1rc_pair_share`` on synthetic records.

Tolerances:

- a vertex on its sphere: 1e-4 units (float32 coordinates up to 681,
  one ulp 6e-5); a normal radial: 1e-5 (float32 unit vectors); a face
  at most 0.08 units inside its sphere (subdivision 3 of radius 16.5
  reaches 0.0752); a wall within 0.052 units of smallpt's radius-1e5
  sphere (its sagitta over the box reaches 0.0511, at the floor's and
  the ceiling's far corners).
- the camera's unit directions: 1e-5 (float32 basis and film scale).
- the port's film against the reference: relative L1 1e-6. The port's
  plain path and the reference run the same float32 operations on the
  CPU (measured 0 on every case); a single sample traced along another
  path moves a 32x24 film of 8 samples a pixel by more than 1e-4.
- ``--scene smallpt``'s corners against the configuration's: 1e-5 (both
  are float64 vertices rounded to float32).

This file imports no JAX: its card test runs on the GPU machine with
``python -m pytest --noconftest tests/test_torch_smallpt.py -q``.
"""

import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from montecarlopathtracer_tpu_torch import cli
from montecarlopathtracer_tpu_torch.models import glossy, smallpt
from montecarlopathtracer_tpu_torch.ops import regen_pass as RP
from montecarlopathtracer_tpu_torch.ops.rng import make_key
from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig, scene_tables
from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
from montecarlopathtracer_tpu_torch.testing import cap_torch_threads
from montecarlopathtracer_tpu_torch.utils import profiling
from perfbench import harness, tracing
from perfbench.drivers import progressive as P
from perfbench.reference import tracer as R
from perfbench.scenes import spheres

cap_torch_threads()

CELL = "smallpt.rr_progressive"
CONF = harness.load_json(harness.ROOT / "perfbench/configs/smallpt.json")
TRAFFIC = harness.load_json(harness.HERE / "traffic/rr_progressive.json")

# smallpt.cpp's spheres[]: radius, position, emission, colour, material.
SMALLPT = {
    "Left": (1e5, (1e5 + 1, 40.8, 81.6), 0.0, (0.75, 0.25, 0.25), "DIFF"),
    "Rght": (1e5, (-1e5 + 99, 40.8, 81.6), 0.0, (0.25, 0.25, 0.75), "DIFF"),
    "Back": (1e5, (50, 40.8, 1e5), 0.0, (0.75, 0.75, 0.75), "DIFF"),
    "Frnt": (1e5, (50, 40.8, -1e5 + 170), 0.0, (0.0, 0.0, 0.0), "DIFF"),
    "Botm": (1e5, (50, 1e5, 81.6), 0.0, (0.75, 0.75, 0.75), "DIFF"),
    "Top": (1e5, (50, -1e5 + 81.6, 81.6), 0.0, (0.75, 0.75, 0.75), "DIFF"),
    "Mirr": (16.5, (27, 16.5, 47), 0.0, (0.999, 0.999, 0.999), "SPEC"),
    "Glas": (16.5, (73, 16.5, 78), 0.0, (0.999, 0.999, 0.999), "REFR"),
    "Lite": (600, (50, 681.6 - 0.27, 81.6), 12.0, (0.0, 0.0, 0.0), "DIFF"),
}
# main(): Ray cam(Vec(50,52,295.6), Vec(0,-0.042612,-1).norm()); cx = Vec(w*.5135/h),
# cy = (cx%cam.d).norm()*.5135; glass index nt = 1.5; w = 1024, h = 768.
CAM_O, CAM_D, FOV, NT, W, H = (50, 52, 295.6), (0, -0.042612, -1), 0.5135, 1.5, 1024, 768
GROUPS = {"Left": "left", "Rght": "right", "Back": "back", "Botm": "bottom", "Top": "top",
          "Mirr": "mirror", "Glas": "glass", "Lite": "light"}


def _arrays(builder_args=None):
    return spheres.build(**(builder_args or CONF["builder_args"]))


def _groups(a):
    """The configuration's triangles by group: {group: (corners f64[n, 3, 3],
    normals f64[n, 3, 3], material)}, the groups laid out in sorted order."""
    out, start = {}, 0
    args = CONF["builder_args"]
    sizes = {p["group"]: 2 for p in args["polygons"]}
    sizes.update({s["group"]: 20 * 4 ** s["subdiv"] for s in args["spheres"]})
    sizes.update({c["group"]: c["segments"] * (2 * c["rings"] - 1) for c in args["caps"]})
    for g in sorted(sizes):
        sl = slice(start, start + sizes[g])
        out[g] = (a.vertices[a.tri_v[sl]].astype(np.float64),
                  a.normals[a.tri_n[sl]].astype(np.float64), int(a.tri_mat[sl][0]))
        assert (a.tri_mat[sl] == out[g][2]).all()
        start += sizes[g]
    assert start == a.num_triangles
    return out


def _deepest(corners, center):
    """The deepest point of each face inside a sphere about ``center``:
    its radius minus the distance of the face's plane (the foot of the
    centre lies inside each face of these near-equilateral triangles)."""
    a, b, c = corners[:, 0], corners[:, 1], corners[:, 2]
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return np.abs(np.einsum("ij,ij->i", a - np.asarray(center), n))


def test_the_configuration_holds_smallpts_numbers():
    a = _arrays()
    assert a.num_triangles == CONF["triangles"] == 2696
    groups = _groups(a)
    assert "front" not in groups  # the black front wall is left out
    for name, (radius, center, emission, colour, refl) in SMALLPT.items():
        if name == "Frnt":
            continue
        corners, normals, m = groups[GROUPS[name]]
        pts = corners.reshape(-1, 3)
        dist = np.linalg.norm(pts - np.asarray(center), axis=1)
        if radius == 1e5:  # a wall on the sphere's inner plane
            assert np.abs(dist - radius).max() <= 0.052, name
            assert np.allclose(a.mat_kd[m], colour) and not a.mat_ka[m].any(), name
            continue
        assert np.abs(dist - radius).max() <= 1e-4, name
        radial = (pts - np.asarray(center)) / radius
        assert np.abs(normals.reshape(-1, 3) - radial).max() <= 1e-5, name
        if refl == "SPEC":
            assert np.allclose(a.mat_ks[m], colour) and not a.mat_kd[m].any()
            assert a.mat_ns[m] >= 1e6 and a.mat_tr[m] == 0.0
            assert (radius - _deepest(corners, center)).max() <= 0.08
        elif refl == "REFR":
            assert np.allclose(a.mat_kd[m], colour) and a.mat_ni[m] == np.float32(NT)
            r0 = ((NT - 1.0) / (NT + 1.0)) ** 2  # Schlick's R0 = 1 - Tr
            assert abs((1.0 - float(a.mat_tr[m])) - r0) < 1e-6
            assert (radius - _deepest(corners, center)).max() <= 0.08
        else:  # the light: its cap below the ceiling, Ka the emission at scale 1
            assert np.allclose(a.mat_ka[m], emission) and not a.mat_kd[m].any()
            assert TRAFFIC["illum"] == 1.0
            assert pts[:, 1].max() == pytest.approx(81.6, abs=1e-4)
            assert pts[:, 1].min() == pytest.approx(center[1] - radius, abs=1e-4)
            rim = np.hypot(pts[:, 0] - center[0], pts[:, 2] - center[2]).max()
            assert rim == pytest.approx(18.0, abs=0.01)


def _smallpt_dirs(xs, ys):
    """smallpt's ray directions through film points (xs, ys) of its own
    rows (y up), normalized: cx (x/w - .5) + cy (y/h - .5) + cam.d."""
    d = np.asarray(CAM_D, np.float64)
    d /= np.linalg.norm(d)
    cx = np.array([W * FOV / H, 0.0, 0.0])
    cy = np.cross(cx, d)
    cy = cy / np.linalg.norm(cy) * FOV
    v = cx[:, None] * (xs / W - 0.5) + cy[:, None] * (ys / H - 0.5) + d[:, None]
    return v / np.linalg.norm(v, axis=0)


def _film_points():
    """Film points (x, y) in the harness's pixels, x right and y down:
    the corners of the film and pixel centres across it."""
    xs = np.array([0.0, W, 0.0, W] + [x + 0.5 for x in (0, 100, 511, 512, 1023)] * 3)
    ys = np.array([0.0, 0.0, H, H] + [y + 0.5 for y in (0, 383, 767) for _ in range(5)])
    return xs, ys


def _pixels(xs, ys):
    """The pixels (x, y) fall in, i64[n] (the last one for x = W or y =
    H), and the offsets of (x, y) from their corners, two f32[n]."""
    px, py = np.minimum(np.floor(xs), W - 1), np.minimum(np.floor(ys), H - 1)
    return (torch.as_tensor((py * W + px).astype(np.int64)),
            torch.as_tensor(xs - px, dtype=torch.float32),
            torch.as_tensor(ys - py, dtype=torch.float32))


def test_the_camera_casts_smallpts_rays():
    ctx = harness.load_context(CELL, 1, 0.0, False, "cpu")
    assert (ctx.width, ctx.height) == (W, H)
    cam = R.make_camera(ctx.camera(), W, H, "cpu")
    assert cam.jitter == 1.0  # so a uniform u moves the ray by 2u - 1 pixels
    xs, ys = _film_points()
    pix, jx, jy = _pixels(xs, ys)
    o, d = R.camera_rays(cam, pix, (jx + 1.0) / 2.0, (jy + 1.0) / 2.0)
    want = _smallpt_dirs(xs, H - ys)  # smallpt writes its row y as image row h - 1 - y
    assert np.abs(d.double().numpy() - want).max() <= 1e-5
    assert np.allclose(o.double().numpy(), np.asarray(CAM_O)[:, None], atol=1e-5)
    # The port's camera of --scene smallpt casts the same rays.
    _, pd = smallpt.smallpt_camera(W, H).generate_rays_soa(pix % W, pix // W, jx, jy, W, H)
    assert np.abs(pd.double().numpy() - want).max() <= 1e-5


def test_every_primary_ray_enters_the_box_through_its_open_front():
    ctx = harness.load_context(CELL, 1, 0.0, False, "cpu")
    cam = R.make_camera(ctx.camera(), W, H, "cpu")
    # The film's corners with the jitter at its ends: every ray lies inside them.
    xs = np.array([-1.0, W + 1.0, -1.0, W + 1.0])
    ys = np.array([-1.0, -1.0, H + 1.0, H + 1.0])
    d = _smallpt_dirs(xs, H - ys)
    t = (170.0 - CAM_O[2]) / d[2]
    x, y = CAM_O[0] + t * d[0], CAM_O[1] + t * d[1]
    assert (x > 1.0).all() and (x < 99.0).all() and (y > 0.0).all() and (y < 81.6).all()
    assert float(cam.tan_y) == pytest.approx(FOV / 2, rel=1e-6)


def test_the_traffic_takes_the_clis_automatic_choices():
    auto = cli.resolve_choices(CONF["triangles"], mode=TRAFFIC["mode"],
                               spp_per_pass=TRAFFIC["spp_per_pass"])
    assert cli.CULL_FROM <= CONF["triangles"] < cli.TRAVERSE_FROM
    assert auto == {"intersector": TRAFFIC["intersector"], "chunk_cull": TRAFFIC["chunk_cull"],
                    "ray_sort": False, "regen": TRAFFIC["regen"], "ray_chunk": 0}
    assert (TRAFFIC["intersector"], TRAFFIC["chunk_cull"], TRAFFIC["regen"]) == \
        ("megakernel", True, True)


def _materials(seed):
    """The configuration's materials redrawn from ``seed``, the light kept:
    Kd, Ks in [0, 0.9], Ns 1 or 1e6, Tr 0 or in [0.5, 1), Ni in [1.2, 1.8]."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, m in CONF["builder_args"]["materials"].items():
        if "Ka" in m:
            out[name] = m
            continue
        out[name] = {"Kd": rng.uniform(0.0, 0.9, 3).tolist(),
                     "Ks": rng.uniform(0.0, 0.9, 3).tolist(),
                     "Ns": float(rng.choice([1.0, 1e6])),
                     "Tr": float(rng.choice([0.0, rng.uniform(0.5, 1.0)])),
                     "Ni": float(rng.uniform(1.2, 1.8))}
    return out


@pytest.mark.parametrize("materials", [None, 1, 2, 3])
def test_the_culled_rr_regen_film_equals_the_reference(materials):
    size = {"width": 32, "height": 24, "spp_per_pass": 4}
    if materials is not None:
        size["builder_args"] = {**CONF["builder_args"], "materials": _materials(materials)}
    ctx = harness.load_context(CELL, 2**31 + 977 + (materials or 0), 0.0, False, "cpu", size)
    scene, camera = P.program_scene(ctx)
    settings = RenderSettings(width=32, height=24, spp_per_pass=4, seed=ctx.seed32, regen=True)
    config = P.trace_config(ctx)
    assert config.chunk_cull and config.mode == "rr"
    r = Renderer(scene, camera, config, settings, device="cpu")
    r.render(2)
    pix = np.arange(32 * 24)
    got = P.film_values({"film": r.film.color}, pix, 32)
    want = P.reference_pixels(ctx, pix, 2)
    assert float(want.sum()) > 0.0
    assert harness.relative_l1(got, want) <= 1e-6


def _corner_set(corners):
    """Each triangle's corners f64[T, 9], rotated to start at its least
    corner (by coordinates rounded to 1e-3), the rows sorted."""
    tri = np.asarray(corners, np.float64).reshape(-1, 3, 3)
    first = [min(range(3), key=lambda k: tuple(np.round(t[k], 3))) for t in tri]
    flat = np.stack([np.roll(t, -f, axis=0) for t, f in zip(tri, first)]).reshape(-1, 9)
    return flat[np.lexsort(np.round(flat, 3).T[::-1])]


def test_the_cli_scene_is_the_configurations_triangles():
    pack, camera = cli.load_scene("smallpt", 64, 48)
    a, b, c = (x.double().numpy() for x in pack.triangle_vertices())
    got = _corner_set(np.stack([a, b, c], axis=1))
    want = _corner_set(np.stack(_arrays().corners(), axis=1))
    assert got.shape == want.shape == (2696, 9)
    assert np.abs(got - want).max() <= 1e-5


def test_the_cli_renders_smallpt_through_the_renderer(tmp_path, capsys):
    out = tmp_path / "s.png"
    assert cli.main(["--device", "cpu", "--scene", "smallpt", "--mode", "rr", "--illum", "1",
                     "--width", "16", "--height", "12", "--spp-per-pass", "1", "--passes", "1",
                     "--out", str(out)]) == 0
    assert out.is_file()
    first = json.loads(capsys.readouterr().err.splitlines()[0])
    assert first == {"choices": {"intersector": "megakernel", "chunk_cull": True,
                                 "ray_sort": False, "regen": True, "ray_chunk": 0},
                     "triangles": 2696}


def test_the_culled_tables_build_is_a_span():
    scene, _ = smallpt.smallpt_scene(width=8, height=6)
    with profile(activities=[ProfilerActivity.CPU]), profiling.recording() as rec:
        scene_tables(scene, TraceConfig(mode="rr", chunk_cull=True))
        scene_tables(scene, TraceConfig(mode="rr"))
    assert rec["spans"]["cull.tables"][0] == 1


@pytest.mark.cuda
def test_a_culled_pass_records_its_chunks_and_tables_span_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene, camera = smallpt.smallpt_scene(width=128, height=96, device="cuda")
    config = TraceConfig(mode="rr", illum=1.0, chunk_cull=True)
    settings = RenderSettings(width=128, height=96, spp_per_pass=4, seed=5, regen=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]), \
            profiling.recording() as rec:
        r = Renderer(scene, camera, config, settings, device="cuda")
        r.render(2)
        torch.cuda.synchronize()
    assert rec["launches"]["B1rc"] == 2 and not rec["launches"].get("B1r")
    assert rec["chunks"] == 2 * math.ceil(2696 / 128)
    assert rec["spans"]["cull.tables"][0] == 1
    assert 0 < rec["vote_chunks"] <= rec["live_steps"] * math.ceil(2696 / 128)
    assert torch.isfinite(r.film.color).all() and float(r.film.color.sum()) > 0.0


def _pair_record(**kw):
    rec = {"passes": 4, "block_steps": 100, "slot_steps": 12_800, "live_steps": 9_600,
           "overflow": 0, "vote_chunks": 105_600, "blocks": 264, "leaf_visits": 480_000,
           "pair_leaves": 450_000, "kernel_ms": 200.0, "tail_ms": 30.0, "grid": 264,
           "chunks": 88, "launches": {"B1rc": 4}, "spans": {}}
    rec.update(kw)
    return rec


def _pair_run(trace=True):
    win = harness.Window(t0=0.0, t1=0.2, events=[(0.05 * i, 0.05 * i + 0.002, 0.05 * (i + 1))
                                                 for i in range(4)], samples_per_event=100)
    summary = tracing.Summary(window_s=0.2, busy_s=0.19, kernels={}, device_ops=[],
                              idle_gaps=[])
    return harness.Run(setup_s=1.0, window=win, kind="progressive",
                       trace=summary if trace else None, work=None, peak={})


def test_the_pair_share_reader_divides_pair_leaves_by_leaf_visits(monkeypatch):
    monkeypatch.setattr(profiling, "traced", lambda: _pair_record())
    share, note = harness.reader("b1rc_pair_share").read(_pair_run())
    assert share == pytest.approx(100.0 * 450_000 / 480_000)
    assert note == "50.0 leaves tested a live lane-step; 450000 of 480000 by the pair path"


@pytest.mark.parametrize("case", ["parent", "no_visits", "unculled", "mixed", "untraced",
                                  "other_passes"])
def test_the_pair_share_reader_reads_nothing_without_its_counters(monkeypatch, case):
    """None for a program that keeps no leaf counters (the parent's record
    lacks them), a window without leaf visits, B1r's launches or a mix,
    an untraced run, and a record that is not the window's."""
    rec = {"parent": {k: v for k, v in _pair_record().items()
                      if k not in ("leaf_visits", "pair_leaves")},
           "no_visits": _pair_record(leaf_visits=0, pair_leaves=0),
           "unculled": _pair_record(launches={"B1r": 4}, leaf_visits=0, pair_leaves=0),
           "mixed": _pair_record(launches={"B1r": 2, "B1rc": 2}),
           "other_passes": _pair_record(passes=5)}.get(case, _pair_record())
    monkeypatch.setattr(profiling, "traced", lambda: rec)
    assert harness.reader("b1rc_pair_share").read(_pair_run(trace=case != "untraced")) is None


PAIR_CASES = {
    # smallpt's closed box, RR: after the first bounce few of a warp's rays
    # reach a voted leaf, so the pair path takes most of them.
    "smallpt_rr": (lambda w, h: smallpt.smallpt_scene(width=w, height=h, device="cuda"),
                   dict(mode="rr", illum=1.0, chunk_cull=True), 96, 72, 4),
    # The glossy stage's camera rays alone (fixed, depth 0), 1 spp: a warp's
    # 64 rays lie side by side in a row, so most voted leaves are reached by
    # many of them and take the per-lane path.
    "glossy_primary": (lambda w, h: glossy.glossy_steps(width=w, height=h, device="cuda"),
                       dict(mode="fixed", max_depth=0, chunk_cull=True), 512, 384, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("which", PAIR_CASES)
def test_the_culled_pass_kernel_equals_the_host_loop_on_either_leaf_path_on_card(which):
    """B1rc's accum and lane steps bit-equal to ``regen_pass_ref`` (the
    host loop over B1l) on the card; its leaf counters: leaves tested and,
    fewer, leaves the pair path took, which are most of them in smallpt
    and fewer than half on the glossy stage's primary rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    make, kw, w, h, spp = PAIR_CASES[which]
    scene, camera = make(w, h)
    config = TraceConfig(**kw)
    tables, key = scene_tables(scene, config), make_key(26)
    stats = {}
    got, steps = RP.regen_pass(tables, config, camera, key, w, h, spp, stats=stats)
    torch.cuda.synchronize()
    want, want_steps = RP.regen_pass_ref(tables, config, camera, key, w, h, spp)
    assert torch.equal(got, want) and torch.equal(steps, want_steps)
    col = {name: int(v) for name, v in zip(RP.STATS, stats["counters"].cpu())}
    assert col["live_steps"] == int(steps.long().sum())
    visits, pair = col["leaf_visits"], col["pair_leaves"]
    print(which, {"leaf_visits": visits, "pair_leaves": pair, "share": 100.0 * pair / visits,
                  "leaves_a_live_lane_step": visits / col["live_steps"]})
    assert 0 < pair < visits
    assert (pair > visits / 2) == (which == "smallpt_rr")
