"""Padding rows in the selection, on the CPU.

The JAX package pads a triangle table to a multiple of 128 with rows whose
geometry is all zero (``tools/kernel_bench.py::pad_scene``: vertices at
the origin, ``tri_valid`` False, so ``pack_transforms`` zeroes them). The
selection loop's sphere rejection (``csrc/sphere_select.cuh::
triangle_sphere``) gives such a row a NaN center, so no ray tests it
exactly. That is exact only if the exact test can never accept an
all-zero row: its o'_z and d'_z are +-0 (NaN for a non-finite origin or
direction), so t = -o'_z / d'_z is NaN and fails ``t > 0``. Here the
plain f32 selection (``segment_fused._select_ref``, the plain counterpart
of ``nearest_common.cuh::pair_test``'s loop) and the split intersector's
plain version (``nearest_shade.nearest_shade_full_ref``) are held to
that: with all-zero rows appended or interleaved, every winner, its t,
beta, gamma and shading row are the bits of the table without them, on
``testing.hard_soup``'s soups and the Cornell box's 64x48 first bounce;
and a table of all-zero rows (signed zeros mixed) accepts no ray, for
origins and directions with +-0 components, zero directions and
non-finite values. The card tests hold the kernels (B1, B4, B4c, B7) to
the same rule (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu_torch.models import cornell
from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS
from montecarlopathtracer_tpu_torch.ops import segment_fused as F
from montecarlopathtracer_tpu_torch.testing import HARD_SOUPS, cap_torch_threads, hard_soup

cap_torch_threads()

BIG = 3.0e38


def _with_zero_rows(rows, layout, seed):
    """(padded rows, new index of each original row): all-zero geometry
    rows (signed zeros mixed, the shading columns random) appended up to
    the next multiple of 128 plus 16 ("trailing"), or one after every
    fourth original row ("interleaved")."""
    T = rows.shape[0]
    rng = np.random.default_rng(seed)
    n_zero = -T % 128 + 16 if layout == "trailing" else T // 4
    zero = torch.zeros(n_zero, rows.shape[1])
    zero[:, :12] = torch.tensor(rng.choice([0.0, -0.0], (n_zero, 12)), dtype=torch.float32)
    zero[:, 12:] = torch.tensor(rng.normal(size=(n_zero, rows.shape[1] - 12)),
                                dtype=torch.float32)
    if layout == "trailing":
        return torch.cat([rows, zero]).contiguous(), torch.arange(T)
    where = torch.zeros(T + n_zero, dtype=torch.bool)  # True where a zero row sits
    where[5 * torch.arange(n_zero) + 4] = True
    out = torch.empty(T + n_zero, rows.shape[1])
    out[where], out[~where] = zero, rows
    return out.contiguous(), torch.nonzero(~where)[:, 0]


def _cornell_bounce():
    """The Cornell box's rows and its 64x48 first-bounce wavefront (with
    dead lanes), jitter and uniforms from a seeded numpy generator."""
    scene, camera = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                        width=64, height=48)
    rows = F.pack_rows_full(scene)
    R = 64 * 48
    rng = np.random.default_rng(5)
    jx, jy, u1, u2, urr = (torch.tensor(rng.uniform(size=R), dtype=torch.float32)
                           for _ in range(5))
    pix = torch.arange(R)
    pos, dir_ = camera.generate_rays_soa(pix % 64, pix // 64, 2 * jx - 1, 2 * jy - 1, 64, 48)
    out = F.mega_segment_ref(rows, pos.contiguous(), dir_.contiguous(), torch.ones(3, R),
                             torch.zeros(3, R), torch.ones(R, dtype=torch.bool), u1, u2, urr,
                             torch.zeros(3, 1))
    live = out[5] > 0
    assert 0.5 < float(live.float().mean()) < 1.0
    return rows, out[1].contiguous(), out[2].contiguous(), live


def _cases():
    yield "cornell bounce", *_cornell_bounce()
    for case in HARD_SOUPS:
        _, rows, pos, dir_ = hard_soup(case, 200, 2048, seed=11)
        yield case, rows, pos, dir_, torch.ones(2048, dtype=torch.bool)


@pytest.mark.parametrize("layout", ["trailing", "interleaved"])
def test_zero_rows_change_no_winner_of_the_plain_selection(layout):
    for k, (name, rows, pos, dir_, live) in enumerate(_cases()):
        padded, new = _with_zero_rows(rows, layout, seed=k)
        for dz_test in (False, True):
            t, i, b, g = F._select_ref(rows, pos, dir_, dz_test=dz_test)
            pt, pi, pb, pg = F._select_ref(padded, pos, dir_, dz_test=dz_test)
            hit = t < BIG
            assert 0.2 < float(hit.float().mean()), (name, float(hit.float().mean()))
            assert torch.equal(pt, t), name
            assert torch.equal(pi[hit], new[i[hit]]), name
            assert torch.equal(pb[hit], b[hit]) and torch.equal(pg[hit], g[hit]), name
            want = NS.nearest_shade_full_ref(rows, pos, dir_, live, dz_test=dz_test)
            got = NS.nearest_shade_full_ref(padded, pos, dir_, live, dz_test=dz_test)
            idx = torch.where(want[0] >= 0, new[want[0].clamp_min(0).long()].int(), -1)
            assert torch.equal(got[0], idx), name
            # A miss's beta and gamma are those of column 0 times 0: NaN where
            # that row holds one (the "degenerate" soup), in both tables.
            for a, b in zip(got[1:], want[1:]):
                torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=name)


def test_zero_rows_accept_no_ray():
    """No ray, however degenerate, passes the exact test on an all-zero
    row: t = -o'_z / d'_z is NaN (+-0 / +-0, or a NaN operand)."""
    values = [0.0, -0.0, 1.0, -2.5, 1e-30, 3e38, float("inf"), -float("inf"), float("nan")]
    rng = np.random.default_rng(3)
    o = np.array(np.meshgrid(values, values, values)).reshape(3, -1)
    d = np.concatenate([o, rng.normal(size=(3, 64)), np.zeros((3, 2)),
                        np.array([[-0.0, 0.0], [0.0, -0.0], [-0.0, -0.0]])], axis=1)
    o = np.concatenate([o, rng.choice(values, (3, d.shape[1] - o.shape[1]))], axis=1)
    rows = torch.zeros(16, 48)
    rows[:, :12] = torch.tensor(rng.choice([0.0, -0.0], (16, 12)), dtype=torch.float32)
    pos = torch.tensor(o, dtype=torch.float32)
    for dir_ in (torch.tensor(d, dtype=torch.float32), torch.zeros_like(pos), -pos):
        for dz_test in (False, True):
            t, _, _, _ = F._select_ref(rows, pos, dir_.contiguous(), dz_test=dz_test)
            assert (t == BIG).all()
        idx, tbg, shade = NS.nearest_shade_full_ref(rows, pos, dir_.contiguous(),
                                                    torch.ones(pos.shape[1], dtype=torch.bool))
        assert (idx == -1).all() and (tbg[0] == BIG).all() and (shade == 0).all()
