"""The reach count: never above the brute-force count, equal to it where
every ray crosses every box before its hit, and one per ray where boxes
lie behind the hit."""

import numpy as np
import torch

import perfbench_testing as PT  # noqa: F401

from perfbench.reference import tracer as R
from perfbench.scenes.assemble import Arrays


def _soup(corners):
    corners = np.asarray(corners, np.float32)
    T = corners.shape[0]
    verts = np.concatenate([np.zeros((1, 3), np.float32), corners.reshape(-1, 3)])
    tri_v = (1 + np.arange(3 * T, dtype=np.int32)).reshape(T, 3)
    normals = np.array([[0, 0, 0], [0, 0, 1]], np.float32)
    z = np.zeros((1, 3), np.float32)
    return Arrays(vertices=verts, normals=normals, tri_v=tri_v,
                  tri_n=np.ones((T, 3), np.int32), tri_mat=np.zeros(T, np.int32),
                  mat_ka=z, mat_kd=z + 0.5, mat_ks=z, mat_ns=np.ones(1, np.float32),
                  mat_tr=np.zeros(1, np.float32), mat_ni=np.ones(1, np.float32))


def _count(arrays, o, d):
    scene = R.prepare_scene(arrays, "cpu")
    o, d = torch.as_tensor(o, dtype=torch.float32), torch.as_tensor(d, dtype=torch.float32)
    hit, t, _, _, idx = R.intersect(scene, o, d)
    return R.boxes_reached(scene, o, d, t, hit, idx), hit


def test_equal_to_brute_force_where_every_box_is_crossed():
    # Triangles over x + y >= 1 in planes z = 1..8; rays up z through
    # (0.2, 0.3) cross every box and miss every triangle.
    corners = [[(1, 0, z), (0, 1, z), (1, 1, z)] for z in range(1, 9)]
    n = 16
    o = np.stack([np.full(n, 0.2), np.full(n, 0.3), np.linspace(-2, 0, n)])
    d = np.stack([np.zeros(n), np.zeros(n), np.ones(n)])
    got, hit = _count(_soup(corners), o, d)
    assert not hit.any()
    assert torch.equal(got, torch.full((n,), len(corners)))


def test_boxes_behind_the_hit_are_not_counted():
    corners = [[(-1, -1, z), (3, -1, z), (-1, 3, z)] for z in range(1, 9)]
    o = np.array([[0.2], [0.3], [0.0]])
    d = np.array([[0.0], [0.0], [1.0]])
    got, hit = _count(_soup(corners), o, d)
    assert bool(hit[0]) and int(got[0]) == 1


def test_never_above_brute_force_on_the_cornell_box():
    from perfbench import harness
    from perfbench.scenes import polygons

    conf = harness.load_json(PT.ROOT / "perfbench/configs/cornell_box.json")
    arrays = polygons.build(**conf["builder_args"])
    rng = np.random.default_rng(5)
    n = 512
    o = rng.uniform(5.0, 545.0, (3, n))
    d = rng.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0)
    got, hit = _count(arrays, o, d)
    assert (got <= arrays.num_triangles).all()
    assert (got[hit] >= 1).all()
    assert got.float().mean() < arrays.num_triangles
