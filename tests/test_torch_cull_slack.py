"""Chunk culling's boxes against the exact test's rounding slack (ROADMAP
C15), on the CPU.

The culling kernels (B1c, B4c) visit the 128-triangle chunks of a
Morton-ordered table in order and skip a chunk whose box a ray's segment
[0, best t] cannot enter. Here a plain emulation of that loop, per lane
(each ray decides alone; the kernels' vote per group of 128 rays only
adds chunks), runs the plain f32 selection (``segment_fused._select_ref``)
chunk by chunk behind ``ops.cull.chunk_reach``, on the seeded hard soups
of ``testing.hard_soup`` at T = 700 and 1500, in identity and Morton
order. With each chunk's box widened by its slack (``ops.cull.
chunk_slack``), every lane must keep its brute-force winner; with the
bare boxes (the margin only), the "slivers" soup at T = 1500 in Morton
order loses two: the exact test accepts hits up to its rounding slack
outside an ill-conditioned triangle.
"""

import pytest
import torch

from montecarlopathtracer_tpu_torch.ops import cull as CU
from montecarlopathtracer_tpu_torch.ops.morton import chunk_aabbs_padded, morton_order
from montecarlopathtracer_tpu_torch.ops.segment_fused import _select_ref
from montecarlopathtracer_tpu_torch.testing import HARD_SOUPS, cap_torch_threads, hard_soup

cap_torch_threads()

R = 16384
BIG = 3.0e38


def _lost_winners(case, T, morton):
    """(lost with the slack, lost with the bare boxes, the slack): lanes
    whose per-lane cull emulation misses the brute winner."""
    verts, rows, pos, dir_ = hard_soup(case, T, R, seed=T)
    valid = torch.ones(T, dtype=torch.bool)
    perm = morton_order(*verts, valid) if morton else torch.arange(T)
    rows = rows[perm].contiguous()
    clo, chi = chunk_aabbs_padded(*verts, valid, perm, 128)
    slack = CU.chunk_slack(rows)
    # Each chunk's own winner (t, index).
    chunks = []
    for j in range(clo.shape[0]):
        t, i, _, _ = _select_ref(rows[128 * j:128 * (j + 1)], pos, dir_)
        chunks.append((t, torch.where(t < BIG, i + 128 * j, -1)))
    o, d = pos.T, dir_.T
    winners = []
    for cull, widen in ((False, None), (True, slack), (True, None)):
        t_run = torch.full((R,), BIG)
        i_run = torch.full((R,), -1, dtype=torch.int64)
        for j, (t, i) in enumerate(chunks):
            reach = not cull or CU.chunk_reach(clo[j:j + 1], chi[j:j + 1], o, d, t_run,
                                               None if widen is None else widen[j:j + 1])[:, 0]
            better = reach & (t < t_run)  # ascending chunks: the smaller index wins a tie
            t_run, i_run = torch.where(better, t, t_run), torch.where(better, i, i_run)
        winners.append(i_run)
    lost = [int((w != winners[0]).sum()) for w in winners[1:]]
    return lost[0], lost[1], slack


@pytest.mark.parametrize("T", [700, 1500])
@pytest.mark.parametrize("case", HARD_SOUPS)
def test_chunk_slack_keeps_every_winner_on_hard_soups(case, T):
    for morton in (False, True):
        with_slack, bare, slack = _lost_winners(case, T, morton)
        assert with_slack == 0, (case, T, morton, with_slack)
        assert (slack >= 0).all() and not slack.isnan().any()
        if (case, T, morton) == ("slivers", 1500, True):
            assert bare == 2, bare  # the fault that the slack repairs


def test_chunk_slack_is_the_largest_sphere_slack_of_each_chunk():
    _, rows, _, _ = hard_soup("degenerate", 300, 8, seed=1)
    from montecarlopathtracer_tpu_torch.ops.traverse_walk import sphere_split_ref

    _, grow, ext = sphere_split_ref(rows)
    never = (rows[:, :12] == 0).all(dim=1)
    slack = CU.chunk_slack(rows)
    assert slack.shape == (3, 2) and slack.dtype == torch.float32
    for j in range(3):
        sel = slice(128 * j, 128 * (j + 1))
        assert slack[j, 0] == torch.where(never[sel], 0.0, ext[sel]).amax()
        assert slack[j, 1] == torch.where(never[sel], 0.0, grow[sel]).amax()
    assert never.any() and torch.isinf(slack[:, 0]).any()  # NaN/inf rows: an unbounded box
