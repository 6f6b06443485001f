"""The port's boundary gradients and fused intersector against the JAX
package's, on the CPU.

- ``unique_edges``: equal to JAX's (the lamp quad: 5 edges, the shared
  diagonal once).
- The primary edge-sampling estimate (``boundary_grad_vertices``) and the
  one-bounce shadow estimate (``shadow_boundary_grad_vertices``) against
  JAX's with the same key: the same stream ids give the same edge
  samples and probe rays, so the estimates agree up to float rounding,
  not only in expectation (1e-4 of the largest entry, atol 1e-7). The
  port weighs the image gradient over each pixel's jittered footprint
  where JAX reads the pixel floor(s) (ROADMAP C8), so JAX is given the
  image gradient filtered by that footprint (the 2x2 mean for the
  cameras' jitter of 1 pixel); given the raw one, it differs. The port
  traces its probes and finds its receivers on the split path's
  megakernel intersector (B4's plain version here), JAX on its brute
  oracle: both select in exact f32.
- The per-vertex rows sum to the translation gradient.
- ``make_translation_problem``: the θ-gradient against a central finite
  difference of the same-key loss, within JAX's own bound
  (``tests/test_boundary.py``: 0.35 × max(|fd|, 0.05)), at 160x120.
- The fused intersector's index (B7): the plain ``nearest_triangle``
  against JAX ``nearest_triangle`` in interpret mode (winners agree on
  99.9% of lanes, mismatches near-ties), and ``refine_hit``'s gradients
  with respect to the transforms and the rays against ``jax.grad`` of
  JAX's ``refine_hit`` (rtol 1e-5, atol 1e-6 of the largest entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from montecarlopathtracer_tpu.diff import boundary as JB
from montecarlopathtracer_tpu.models import cornell as jcornell
from montecarlopathtracer_tpu.models.cornell import _Builder
from montecarlopathtracer_tpu.ops import intersect_pallas as JP
from montecarlopathtracer_tpu.ops.intersect import triangle_transforms as jax_transforms
from montecarlopathtracer_tpu.render.integrator import TraceConfig as JTraceConfig
from montecarlopathtracer_tpu.scene.camera import Camera as JCamera
from montecarlopathtracer_tpu.scene.scene import scene_pack_from_model as jax_pack
from montecarlopathtracer_tpu_torch.diff import boundary as B
from montecarlopathtracer_tpu_torch.models import cornell
from montecarlopathtracer_tpu_torch.models.cornell import _Assembler
from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS
from montecarlopathtracer_tpu_torch.ops.intersect import triangle_transforms
from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key
from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig, render_sample_batch
from montecarlopathtracer_tpu_torch.scene.camera import Camera
from montecarlopathtracer_tpu_torch.scene.scene import scene_pack_from_model
from montecarlopathtracer_tpu_torch.testing import compare_winners

JCFG = JTraceConfig(mode="fixed", max_depth=2, ray_chunk=0)  # the JAX tests' (brute)
CFG = TraceConfig(mode="fixed", max_depth=2, whole_segment=False)  # B4 on the split path


def _lamp_problem(W=32, H=32):
    js, jcam = jcornell.cornell_box(width=W, height=H)
    ts, tcam = cornell.cornell_box(width=W, height=H)
    ka = ts.mat_ka.numpy()
    emit = np.where((ka > 0).any(axis=1))[0]
    T = ts.num_triangles
    tri_mask = np.isin(ts.tri_mat.numpy(), emit)
    jmask = np.zeros(js.tri_v.shape[0], bool)
    jmask[:T] = tri_mask
    return js, jcam, ts, tcam, tri_mask, jmask


def _footprint_filtered(g):
    """The image gradient that JAX's one-pixel lookup at floor(s) must be
    given to weigh a screen point as the port does for a camera jitter of
    1 pixel: the mean of pixels (x, y) .. (x + 1, y + 1), 0 beyond the
    frame."""
    p = np.pad(g, ((0, 1), (0, 1), (0, 0)))
    return (p[:-1, :-1] + p[1:, :-1] + p[:-1, 1:] + p[1:, 1:]) / 4.0


def _assert_estimates_agree(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0.0
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-4 * scale + 1e-7)


def test_unique_edges_match_jax():
    js, _, ts, _, tri_mask, jmask = _lamp_problem()
    e = B.unique_edges(ts.tri_v.numpy(), tri_mask)
    assert tri_mask.sum() == 2 and e.shape == (5, 2) and e.dtype == np.int32
    np.testing.assert_array_equal(e, JB.unique_edges(js.tri_v, jmask))


def test_primary_boundary_estimate_matches_jax():
    W = H = 32
    js, jcam, ts, tcam, tri_mask, jmask = _lamp_problem(W, H)
    image_grad = np.random.RandomState(0).normal(size=(H, W, 3)).astype(np.float32) * 1e-3
    edges = B.unique_edges(ts.tri_v.numpy(), tri_mask)
    kw = dict(width=W, height=H, n_samples=1024)
    want = JB.boundary_grad_vertices(js, jcam, jnp.asarray(edges),
                                     jnp.asarray(_footprint_filtered(image_grad)),
                                     jax.random.key(3), config=JCFG, **kw)
    got = B.boundary_grad_vertices(ts, tcam, edges, torch.from_numpy(image_grad), make_key(3),
                                   config=CFG, **kw)
    _assert_estimates_agree(got, want)
    raw = JB.boundary_grad_vertices(js, jcam, jnp.asarray(edges), jnp.asarray(image_grad),
                                    jax.random.key(3), config=JCFG, **kw)
    assert not np.allclose(got.numpy(), np.asarray(raw), rtol=0.0,
                           atol=1e-4 * np.abs(np.asarray(raw)).max())
    # Linearity: the per-vertex rows sum to the translation gradient, and
    # only the edges' end vertices receive any.
    g3 = B.boundary_grad_translation(ts, tcam, edges, torch.from_numpy(image_grad),
                                     make_key(3), config=CFG, **kw)
    torch.testing.assert_close(got.sum(dim=0), g3, rtol=1e-5, atol=1e-7)
    off = np.ones(ts.vertices.shape[0], bool)
    off[np.unique(edges)] = False
    assert (got.numpy()[off] == 0.0).all()


def _shadow_scenes(W, H):
    """tests/test_shadow_boundary.py's scene: a floor, a dark blocker
    behind a downward-looking camera, a lamp above it."""
    packs = []
    for builder, pack_fn in ((_Builder, jax_pack), (_Assembler, scene_pack_from_model)):
        b = builder()
        white = b.add_material("white", Kd=(0.8, 0.8, 0.8))
        dark = b.add_material("dark", Kd=(0.2, 0.2, 0.2))
        light = b.add_material("light", Ka=(1.0, 1.0, 1.0))
        s, hw = 6.0, 0.5
        b.add_quad("floor", white, (-s, 0, -s), (-s, 0, s), (s, 0, s), (s, 0, -s), (0, 1, 0))
        b.add_quad("blocker", dark, (-hw, 3, -hw), (-hw, 3, hw), (hw, 3, hw), (hw, 3, -hw),
                   (0, -1, 0))
        b.add_quad("lamp", light, (-1, 4.5, -1), (1, 4.5, -1), (1, 4.5, 1), (-1, 4.5, 1),
                   (0, -1, 0))
        packs.append(pack_fn(b.model))
    look = ((0.0, 2.2, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, -1.0))
    return (packs[0], JCamera.look(*look, width=W, height=H), packs[1],
            Camera.look(*look, width=W, height=H))


def test_shadow_boundary_estimate_matches_jax():
    W = H = 24
    js, jcam, ts, tcam = _shadow_scenes(W, H)
    kd = ts.mat_kd.numpy()
    tri_mask = ts.tri_mat.numpy() == int(np.where(np.isclose(kd[:, 0], 0.2))[0][0])
    assert tri_mask.sum() == 2
    edges = B.unique_edges(ts.tri_v.numpy(), tri_mask)
    image_grad = np.random.RandomState(1).normal(size=(H, W, 3)).astype(np.float32) * 1e-3
    kw = dict(width=W, height=H, n_samples=2048)
    want = JB.shadow_boundary_grad_vertices(js, jcam, jnp.asarray(edges),
                                            jnp.asarray(_footprint_filtered(image_grad)),
                                            jax.random.key(4), config=JCFG, **kw)
    got = B.shadow_boundary_grad_vertices(ts, tcam, edges, torch.from_numpy(image_grad),
                                          make_key(4), config=CFG, **kw)
    _assert_estimates_agree(got, want)
    g3 = B.shadow_boundary_grad_translation(ts, tcam, edges, torch.from_numpy(image_grad),
                                            make_key(4), config=CFG, **kw)
    torch.testing.assert_close(got.sum(dim=0), g3, rtol=1e-5, atol=1e-9)


def test_translation_gradient_matches_finite_difference():
    """BASELINE config 5 on the CPU: at a displaced lamp the boundary
    θ-gradient matches a central difference of the same-key loss. At
    160x120 and 2 spp the ratio of the two is steady from key to key; at
    32x32 it swings by several times."""
    W, H, spp = 160, 120, 2
    _, _, ts, tcam, tri_mask, _ = _lamp_problem(W, H)
    target = sum(render_sample_batch(ts, tcam, fold_in(make_key(123), i), W, H, CFG)
                 for i in range(spp)) / spp
    step = B.make_translation_problem(ts, tcam, tri_mask, target, width=W, height=H, spp=spp,
                                      config=CFG, n_edge_samples=4096)
    th, h = torch.tensor([1.2, 0.0, 0.0]), 0.05
    loss, g = step(th, make_key(0))
    lp, _ = step(th + torch.tensor([h, 0.0, 0.0]), make_key(0))
    lm, _ = step(th - torch.tensor([h, 0.0, 0.0]), make_key(0))
    fd = float((lp - lm) / (2 * h))
    gx = float(g[0])
    assert torch.isfinite(loss) and torch.isfinite(g).all()
    assert gx > 0.0, "the gradient must point away from larger offsets"
    assert abs(gx - fd) < 0.35 * max(abs(fd), 0.05), (gx, fd)


def test_nearest_triangle_plain_matches_jax():
    js, _ = jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True)
    m, m_a = jax_transforms(*js.triangle_vertices())
    rs = np.random.RandomState(2)
    R = 2000
    origins = rs.uniform([-5.5, 0.5, -5.5], [5.5, 9.5, 5.5], (R, 3)).astype(np.float32)
    origins[: R // 2] = [0.0, 5.0, 17.0]
    dirs = rs.normal(size=(R, 3))
    dirs[: R // 2] = rs.uniform([-6, 0, -6], [6, 10, 6], (R // 2, 3)) - origins[: R // 2]
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    w = JP.pack_transforms(m, m_a, js.tri_valid)
    want = np.asarray(JP.nearest_triangle(w, jnp.asarray(origins), jnp.asarray(dirs),
                                          interpret=True))
    geom = NS.pack_geom_rows(torch.from_numpy(np.asarray(m)), torch.from_numpy(np.asarray(m_a)),
                             torch.from_numpy(np.asarray(js.tri_valid)))
    pos, d = torch.from_numpy(origins.T.copy()), torch.from_numpy(dirs.T.copy())
    before = NS.nearest_triangle.launches
    got = NS.nearest_triangle(geom, pos, d)
    assert NS.nearest_triangle.launches == before and got.dtype == torch.int32
    rep = compare_winners(got, want, live=np.ones(R, bool), rows=geom.numpy(),
                          pos=origins.T, dir_=dirs.T)
    assert rep["ok"], rep
    assert 0.5 < (got.numpy() >= 0).mean() < 1.0


def test_refine_hit_gradients_match_jax():
    ts, _ = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True)
    rs = np.random.RandomState(3)
    R = 500
    origins = rs.uniform([-5.5, 0.5, -5.5], [5.5, 9.5, 5.5], (R, 3)).astype(np.float32)
    dirs = rs.normal(size=(R, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    m, m_a = triangle_transforms(*ts.triangle_vertices())
    tri_id = NS.intersect_fused(m, m_a, ts.tri_valid, torch.from_numpy(origins),
                                torch.from_numpy(dirs)).tri_id
    assert 0.5 < (tri_id >= 0).float().mean() < 1.0
    wts = rs.normal(size=(6, R)).astype(np.float32)

    def loss(hit, xp):
        w, point = xp.asarray(wts), hit.point
        return xp.sum(w[0] * xp.where(hit.tri_id < 0, 0.0, hit.t) + w[1] * hit.beta
                      + w[2] * hit.gamma + w[3] * point[:, 0] + w[4] * point[:, 1]
                      + w[5] * point[:, 2])

    args = (m.detach().numpy(), m_a.detach().numpy(), origins, dirs)
    jgrads = jax.grad(lambda *a: loss(JP.refine_hit(*a, jnp.asarray(tri_id.numpy())), jnp),
                      argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    xs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    loss(NS.refine_hit(*xs, tri_id), torch).backward()
    for x, jg in zip(xs, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(x.grad.numpy(), jg, rtol=1e-5, atol=1e-6 * np.abs(jg).max())
