"""The port's chunk-cull path against the JAX package's, on the CPU.

- The glossy stage (``models/glossy.py``), the cull path's scene: every
  field of the JAX package's pack (its first T = 1,332 triangles) and its
  camera, exactly.
- The culling segment (B1c): the port's plain ``mega_segment`` on the
  Morton-ordered glossy table against JAX ``mega_segment_fwd(cull=True)``
  in interpret mode, with scalar and per-lane flags, fixed and RR, with
  the tolerances of ``tests/test_torch_segment.py`` (winners agree on
  99.9% of live lanes, mismatches near-ties; npos and ndir to atol 1e-3
  against the kernel's approximate reciprocal, the rest to 1e-5). The
  plain version ignores the chunk boxes: culling only prunes, so the
  winners are brute selection's on the permuted table.
- Cull renders (whole segment, ray sort on and off) against the JAX
  package's at 32x24, depth 2, fixed and RR (``testing.compare_images``;
  measured equal), and against the port's render without culling.
- Regen with ``chunk_cull`` (B1c with per-lane flags) against the JAX
  package's regen with ``chunk_cull``, and bit-identical to the port's
  scan at spp = 1.
- The CLI renders the glossy stage with ``--chunk-cull on`` and refuses
  ``--chunk-cull on`` with another intersector and ``--regen on`` with
  ``fused`` or ``brute``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu.models import glossy as jglossy
from montecarlopathtracer_tpu.ops import intersect_pallas as JP
from montecarlopathtracer_tpu.ops import segment_fused as JF
from montecarlopathtracer_tpu.ops.intersect import triangle_transforms
from montecarlopathtracer_tpu.render.integrator import (
    TraceConfig as JTraceConfig,
    render_sample_batch as jax_render_sample_batch,
)
from montecarlopathtracer_tpu.render.regen import render_regen_planar as jax_regen
from montecarlopathtracer_tpu_torch import cli
from montecarlopathtracer_tpu_torch.models import glossy
from montecarlopathtracer_tpu_torch.ops import segment_fused as F
from montecarlopathtracer_tpu_torch.ops.rng import make_key
from montecarlopathtracer_tpu_torch.render.integrator import (
    TraceConfig,
    render_rows_planar,
    render_sample_batch,
    scene_tables,
)
from montecarlopathtracer_tpu_torch.render.regen import render_regen_planar
from montecarlopathtracer_tpu_torch.scene.scene import FIELDS
from montecarlopathtracer_tpu_torch.testing import compare_images, compare_segment
from montecarlopathtracer_tpu_torch.utils.image import load_png

R = 3000


def test_glossy_scene_matches_jax():
    js, jcam = jglossy.glossy_steps(width=40, height=30)
    ts, tcam = glossy.glossy_steps(width=40, height=30)
    T = ts.num_triangles
    assert T == 1332
    assert bool(np.asarray(js.tri_valid)[:T].all()) and not np.asarray(js.tri_valid)[T:].any()
    for f in FIELDS:
        want = np.asarray(getattr(js, f))
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      want[:T] if f.startswith("tri_") else want, f)
    for f in ("eye", "forward", "up", "right", "tan_half_x", "tan_half_y"):
        np.testing.assert_array_equal(getattr(tcam, f).numpy(), np.asarray(getattr(jcam, f)), f)


@pytest.fixture(scope="module")
def cull_tables():
    """The JAX package's Morton-ordered glossy tables (ws, rows padded to
    128 triangles, chunk boxes)."""
    js, _ = jglossy.glossy_steps()
    a, b, c = js.triangle_vertices()
    m, m_a = triangle_transforms(a, b, c)
    perm = JP.morton_order(a, b, c, js.tri_valid)
    ws = JP.pack_transforms_stream(m[perm], m_a[perm], js.tri_valid[perm], 128)
    rows = np.asarray(JP.pack_rows_full(m[perm], m_a[perm], js, 128, perm=perm))
    clo, chi = JP.chunk_aabbs_padded(a, b, c, js.tri_valid, perm, 128)
    return ws, rows, clo, chi


def _inputs(seed, lane):
    """Half camera rays from the scene-2 eye, half rays from random
    points above the cubes in random directions (a cube's bottom face
    lies in the floor's plane: a ray from inside one meets both at the
    same t); ~10% dead; random state, uniforms and (lane) per-lane
    flags."""
    rs = np.random.RandomState(seed)
    h = R // 2
    pos = np.empty((3, R), np.float32)
    dirs = np.empty((3, R), np.float32)
    pos[:, :h] = np.array([[0.0], [5.0], [23.0]])
    dirs[:, :h] = rs.uniform([-10, 0, -8], [10, 8, 4], (h, 3)).T - pos[:, :h]
    pos[:, h:] = rs.uniform([-9, 3.0, -7], [9, 12, 9], (R - h, 3)).T
    dirs[:, h:] = rs.normal(size=(3, R - h))
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    x = dict(pos=pos, dir=dirs, tput=rs.uniform(0.05, 1.0, (3, R)),
             res=rs.uniform(0.0, 0.5, (3, R)), u1=rs.uniform(size=R), u2=rs.uniform(size=R),
             urr=rs.uniform(size=R))
    x = {k: v.astype(np.float32) for k, v in x.items()}
    x["live"] = rs.uniform(size=R) > 0.1
    if lane:
        x["flags"] = (rs.uniform(size=(3, R)) < [[0.3], [0.5], [0.2]]).astype(np.float32)
    else:
        x["flags"] = np.asarray([[0.0], [1.0], [0.0]], np.float32)
    return x


@pytest.mark.parametrize("lane", [False, True], ids=["scalar_flags", "lane_flags"])
@pytest.mark.parametrize("mode", ["fixed", "rr"])
def test_cull_segment_plain_matches_jax(cull_tables, mode, lane):
    ws, rows, clo, chi = cull_tables
    x = _inputs(seed=len(mode) + 2 * lane, lane=lane)
    kw = dict(mode=mode, illum=10.0 if mode == "fixed" else 1.0, eps_offset=0.01,
              refract_kd=True, phong_model="blinn")
    want = JF.mega_segment_fwd(ws, rows, x["pos"], x["dir"], x["tput"], x["res"],
                               jnp.asarray(x["live"]), x["u1"], x["u2"], x["urr"], x["flags"],
                               clo, chi, t_chunk=128, cull=True, interpret=True,
                               lane_flags=lane, **kw)
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    before = (F.mega_segment.launches, F.mega_segment.cull_launches)
    got = F.mega_segment(torch.from_numpy(rows.copy()), t["pos"], t["dir"], t["tput"],
                         t["res"], t["live"], t["u1"], t["u2"], t["urr"], t["flags"],
                         clo=torch.tensor(np.asarray(clo)), chi=torch.tensor(np.asarray(chi)),
                         **kw)
    assert (F.mega_segment.launches, F.mega_segment.cull_launches) == before
    rep = compare_segment(want, got, live=x["live"], rows=rows, pos=x["pos"], dir_=x["dir"],
                          tol={"npos": (1e-5, 1e-3), "ndir": (1e-5, 1e-3)})
    assert rep["ok"], rep
    idx = got[0].numpy()
    assert 0.3 < (idx[x["live"]] >= 0).mean() < 1.0  # the open stage: many misses


FIXED = dict(max_depth=2)
RR = dict(mode="rr", rr_depth=1, illum=1.0, refract_kd=False)


@pytest.mark.parametrize("ray_sort", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("mode", [FIXED, RR], ids=["fixed", "rr"])
def test_cull_render_matches_jax(mode, ray_sort):
    W, H = 32, 24
    js, jcam = jglossy.glossy_steps(width=W, height=H)
    ts, tcam = glossy.glossy_steps(width=W, height=H)
    kw = dict(chunk_cull=True, ray_sort=ray_sort, **mode)
    want = jax_render_sample_batch(js, jcam, jax.random.key(7), W, H,
                                   JTraceConfig(intersector="megakernel", pallas_interpret=True,
                                                ray_chunk=0, **kw))
    tables = scene_tables(ts, TraceConfig(**kw))
    assert tables.clo.shape == (11, 3) and tables.perm.shape == (1332,)
    got = render_sample_batch(ts, tcam, make_key(7), W, H, TraceConfig(**kw), tables)
    rep = compare_images(got.numpy(), np.asarray(want))
    assert rep["ok"], rep
    assert np.asarray(want).mean() > 0.0
    plain = render_sample_batch(ts, tcam, make_key(7), W, H, TraceConfig(**mode))
    assert compare_images(got.numpy(), plain.numpy())["ok"]


def test_cull_regen_matches_jax_and_scan():
    W, H = 24, 18
    js, jcam = jglossy.glossy_steps(width=W, height=H)
    ts, tcam = glossy.glossy_steps(width=W, height=H)
    kw = dict(mode="rr", rr_depth=2, illum=1.0, chunk_cull=True)
    want = jax_regen(js, jcam, jax.random.key(4), W, H, 3,
                     JTraceConfig(intersector="megakernel", pallas_interpret=True, ray_chunk=0,
                                  **kw))
    got = render_regen_planar(ts, tcam, make_key(4), W, H, 3, TraceConfig(**kw))
    rep = compare_images(got.permute(1, 2, 0).numpy(), np.asarray(want).transpose(1, 2, 0))
    assert rep["ok"], rep
    assert np.asarray(want).mean() > 0.0
    # At spp = 1 no lane regenerates: the scan's estimate, bit for bit.
    cfg = TraceConfig(**kw)
    a = render_rows_planar(ts, tcam, make_key(5), W, H, 0, H, cfg)
    b = render_regen_planar(ts, tcam, make_key(5), W, H, 1, cfg)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cli_glossy_cull_and_refusals(tmp_path, capsys):
    out = str(tmp_path / "g.png")
    rc = cli.main(["--device", "cpu", "--scene", "glossy", "--chunk-cull", "on",
                   "--ray-sort", "on", "--width", "24", "--height", "18",
                   "--spp-per-pass", "1", "--passes", "1", "--max-depth", "2",
                   "--out", out, "--quiet"])
    assert rc == 0 and load_png(out).max() > 0
    for argv, msg in ((["--chunk-cull", "on", "--intersector", "fused"], "--chunk-cull on"),
                      (["--regen", "on", "--intersector", "brute"], "--regen on")):
        bad = str(tmp_path / "bad.png")
        rc = cli.main(["--device", "cpu", "--width", "8", "--height", "6", "--passes", "1",
                       "--out", bad, *argv])
        assert rc == 2 and msg in capsys.readouterr().err
        assert not os.path.exists(bad)
    ts, tcam = glossy.glossy_steps(width=8, height=6)
    with pytest.raises(ValueError, match="regen"):
        render_regen_planar(ts, tcam, make_key(0), 8, 6, 1, TraceConfig(intersector="fused"))
