"""B5's tables on the CPU: the plain version that the one-launch kernel
B5t (``csrc/traverse_select.cu::traverse_tables_launch``) is held to.

``ops.traverse_walk.walk_tables`` on CPU tensors runs
``walk_tables_ref``. Here, on ``testing.hard_soup``'s soups in Morton
order (T = 20, 700 and 1500, leaves of 32 and 128 triangles) and on the
subdivision-3 bunny as the render path builds them: the records are each
triangle's ``sphere_split_ref`` sphere then its geometry row, bit for
bit; the leaves are the boxes with the largest slack and growth of their
triangles; the tree is ``tree_ref`` over those leaves, each interior node
the fmin/fmax of its children; padding leaves, the nodes over padding
only and node 0 are empty. Trees of 1 and 3 leaves (P = 1 and 4), the
kernel's edge cases, are spelled out node by node.
"""

import pytest
import torch

from montecarlopathtracer_tpu_torch.models import bunny
from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW
from montecarlopathtracer_tpu_torch.ops.morton import chunk_aabbs_padded, morton_order
from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig, scene_tables
from montecarlopathtracer_tpu_torch.testing import HARD_SOUPS, cap_torch_threads, hard_soup

cap_torch_threads()

BIG = 3.0e38
EMPTY = torch.tensor([BIG, BIG, BIG, 0.0, -BIG, -BIG, -BIG, 0.0])


def _bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _morton(case, T, leaf):
    verts, rows, _, _ = hard_soup(case, T, 8, seed=T)
    valid = torch.ones(T, dtype=torch.bool)
    perm = morton_order(*verts, valid)
    clo, chi = chunk_aabbs_padded(*verts, valid, perm, leaf)
    return rows[perm].contiguous(), clo, chi


def _check_tables(tables, rows, clo, chi, leaf):
    T, nc = rows.shape[0], clo.shape[0]
    P = TW.tree_leaves(nc)
    assert tables.leaf == leaf and tables.leaves == P and tables.tree.shape == (2 * P, 8)
    sph, grow, slack = TW.sphere_split_ref(rows)
    assert tables.tri.shape == (T, 16) and tables.tri.is_contiguous()
    assert _bits(tables.tri[:, :4], sph) and _bits(tables.tri[:, 4:], rows[:, :12])
    pad = nc * leaf - T
    ext, gro = (torch.nn.functional.pad(x, (0, pad)).reshape(nc, leaf).amax(1)
                for x in (slack, grow))
    tree = tables.tree
    assert _bits(tree[P:P + nc, [0, 1, 2]], clo) and _bits(tree[P:P + nc, [4, 5, 6]], chi)
    assert _bits(tree[P:P + nc, 3], ext) and _bits(tree[P:P + nc, 7], gro)
    assert _bits(tree, TW.tree_ref(clo, chi, ext, gro))
    assert _bits(tree[0], EMPTY) and _bits(tree[P + nc:], EMPTY.expand(P - nc, 8))
    for n in range(1, P):
        a, b = tree[2 * n], tree[2 * n + 1]
        lo = torch.cat([torch.fmin(a[:3], b[:3]), torch.fmax(a[3:4], b[3:4])])
        assert _bits(tree[n], torch.cat([lo, torch.fmax(a[4:], b[4:])])), n


@pytest.mark.parametrize("leaf", [TW.LEAF, TW.CHUNK])
@pytest.mark.parametrize("case", HARD_SOUPS)
def test_walk_tables_ref_on_morton_hard_soups(case, leaf):
    for T in (20, 700, 1500):
        rows, clo, chi = _morton(case, T, leaf)
        _check_tables(TW.walk_tables(rows, clo, chi, leaf), rows, clo, chi, leaf)


def test_walk_tables_ref_on_the_bunny():
    scene, _ = bunny.bunny_scene(subdiv=3, width=16, height=12)
    t = scene_tables(scene, TraceConfig(intersector="traverse"))
    rows = t.rows.detach()
    lo, hi, big = TW.walk_boxes(*scene.triangle_vertices(), scene.tri_valid, t.perm)
    assert torch.equal(t.walk.big, big) and big.shape[0] > 0
    _check_tables(t.walk, rows, lo, hi, TW.LEAF)
    _check_tables(TW.walk_tables(rows, t.clo, t.chi), rows, t.clo, t.chi, TW.CHUNK)


@pytest.mark.parametrize("T", [20, 70], ids=["one_leaf", "three_leaves"])
def test_small_trees_have_empty_padding_and_node_0(T):
    """Leaves of 32: T = 20 is one leaf (P = 1: node 1 is the leaf and the
    root), T = 70 three (P = 4: leaf 3, node 7, is padding; node 3 holds
    leaf 2 alone; the root holds all three)."""
    rows, clo, chi = _morton("random", T, TW.LEAF)
    tree = TW.walk_tables(rows, clo, chi, TW.LEAF).tree
    nc = -(-T // TW.LEAF)
    P = TW.tree_leaves(nc)
    assert (nc, P, tree.shape[0]) == ((1, 1, 2) if T == 20 else (3, 4, 8))
    assert _bits(tree[0], EMPTY)
    assert (tree[1, :3] == clo.amin(0)).all() and (tree[1, 4:7] == chi.amax(0)).all()
    assert (tree[1:P + nc, 3] > 0).all() and (tree[1:P + nc, 7] > 0).all()
    if T == 70:
        assert _bits(tree[7], EMPTY)
        assert _bits(tree[3], tree[6])
        assert (tree[2, :3] == clo[:2].amin(0)).all() and (tree[2, 4:7] == chi[:2].amax(0)).all()
