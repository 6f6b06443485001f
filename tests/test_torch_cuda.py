"""The port's CUDA kernels on the card (the segment forward with scalar
and per-lane flags and with chunk culling, its vjp, the row scatter, the
traversal walk, the segment from known winners, the split path's nearest
hit with and without culling and the fused intersector's index, the
superseded selection entries over it, the selection microkernels): each
builds, launches, agrees with its plain-torch version, counts its
launches and refuses what it cannot take; gradient, traversal, regen,
split, fused, cull and kdtree renders through the kernels agree with the
plain path. Every test here needs an NVIDIA Hopper GPU and
nvcc, and skips elsewhere. This file imports no JAX; run it on the GPU machine, from the
repository root, without the JAX-pinning conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from montecarlopathtracer_tpu_torch.diff import grad as G
from montecarlopathtracer_tpu_torch.models import bunny, cornell, glossy
from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS
from montecarlopathtracer_tpu_torch.ops import nearest_variants as NV
from montecarlopathtracer_tpu_torch.ops import selection_micro as SM
from montecarlopathtracer_tpu_torch.ops import scatter_rows as S
from montecarlopathtracer_tpu_torch.ops import segment_fused as F
from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW
from montecarlopathtracer_tpu_torch.ops.intersect import triangle_transforms
from montecarlopathtracer_tpu_torch.ops.morton import chunk_aabbs, chunk_aabbs_padded
from montecarlopathtracer_tpu_torch.ops.rng import make_key, stream_uniform
from montecarlopathtracer_tpu_torch.render.integrator import (
    TraceConfig,
    render_sample_batch,
    scene_tables,
)
from montecarlopathtracer_tpu_torch.render.regen import render_regen_batch
from montecarlopathtracer_tpu_torch.testing import (
    compare_grads,
    compare_images,
    compare_param_grads,
    compare_scatter,
    compare_segment,
    compare_shade,
    compare_winners,
    plain_kernels,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    scene, camera = cornell.cornell_box(
        with_mirror_sphere=True, with_glass_sphere=True, width=64, height=48,
        device="cuda",
    )
    return scene, camera, F.pack_rows_full(scene)


def _camera_args(camera, rows, flags, key=make_key(1)):
    R = 64 * 48
    pix = torch.arange(R, device="cuda")
    jx = stream_uniform(key, 1 << 30, R, "cuda") * 2 - 1
    jy = stream_uniform(key, (1 << 30) + 1, R, "cuda") * 2 - 1
    pos, dir_ = camera.generate_rays_soa(pix % 64, pix // 64, jx, jy, 64, 48)
    return (rows, pos.contiguous(), dir_, torch.ones(3, R, device="cuda"),
            torch.zeros(3, R, device="cuda"),
            torch.ones(R, dtype=torch.bool, device="cuda"),
            *(stream_uniform(key, s, R, "cuda") for s in (0, 1, 3)),
            torch.tensor(flags, device="cuda").reshape(3, 1))


@pytest.mark.parametrize("mode,flags", [
    ("fixed", [0.0, 0.0, 0.0]), ("fixed", [1.0, 0.0, 0.0]),
    ("rr", [0.0, 1.0, 0.0]), ("rr", [0.0, 0.0, 1.0]),
])
def test_kernel_matches_plain_on_card(card, mode, flags):
    _, camera, rows = card
    args = _camera_args(camera, rows, flags)
    before = F.mega_segment.launches
    got = F.mega_segment(*args, mode=mode)
    torch.cuda.synchronize()
    assert F.mega_segment.launches == before + 1
    want = F.mega_segment_ref(*args, mode=mode)
    rep = compare_segment(want, got, live=args[5], rows=rows, pos=args[1], dir_=args[2])
    assert rep["ok"], rep


def test_wrapper_refuses_bad_inputs_on_card(card):
    _, camera, rows = card
    args = list(_camera_args(camera, rows, [0.0, 0.0, 0.0]))
    before = F.mega_segment.launches
    bad = list(args)
    bad[1] = torch.ones(args[1].shape[1], 3, device="cuda").T  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        F.mega_segment(*bad)
    bad = list(args)
    bad[5] = args[5].to(torch.float32)
    with pytest.raises(TypeError, match="live"):
        F.mega_segment(*bad)
    bad = list(args)
    bad[0] = rows.cpu()
    with pytest.raises(ValueError, match="on"):
        F.mega_segment(*bad)
    assert F.mega_segment.launches == before


def test_render_on_card_matches_cpu_plain_path(card):
    scene, camera, _ = card
    config = TraceConfig(max_depth=3)
    got = render_sample_batch(scene, camera, make_key(2), 64, 48, config)
    want = render_sample_batch(scene.to("cpu"), camera.to("cpu"), make_key(2),
                               64, 48, config)
    rep = compare_images(got, want)
    assert rep["ok"], rep


def _backward_args(camera, rows, mode, flags, tput=None):
    """A first-bounce wavefront, its winners and random cotangents."""
    args = list(_camera_args(camera, rows, [0.0, 0.0, 0.0]))
    out = F.mega_segment(*args)
    args[1:6] = [out[1], out[2], out[3] if tput is None else tput, out[4], out[5] > 0]
    args[9] = torch.tensor(flags, device="cuda").reshape(3, 1)
    idx = F.mega_segment(*args, mode=mode)[0]
    full = rows.T.contiguous()[:, idx.clamp_min(0).long()]
    g = torch.Generator(device="cuda").manual_seed(3)
    cts = [torch.randn(args[1].shape, device="cuda", generator=g) for _ in range(4)]
    return idx, (*args[1:6], idx >= 0, full, *args[6:10], *cts)


@pytest.mark.parametrize("mode,flags,opts", [
    ("fixed", [0.0, 0.0, 0.0], {}), ("fixed", [1.0, 0.0, 0.0], {}),
    ("rr", [0.0, 1.0, 0.0], {"tied": True}), ("rr", [0.0, 0.0, 1.0], {}),
    ("fixed", [0.0, 0.0, 0.0], {"phong_model": "phong"}),
])
def test_segment_backward_kernel_matches_plain(card, mode, flags, opts):
    _, camera, rows = card
    opts = dict(opts)
    tput = torch.full((3, 64 * 48), 0.6, device="cuda") if opts.pop("tied", False) else None
    idx, args = _backward_args(camera, rows, mode, flags, tput)
    before = F.segment_backward.launches
    got = F.segment_backward(*args, mode=mode, **opts)
    torch.cuda.synchronize()
    assert F.segment_backward.launches == before + 1
    want = F.segment_backward_ref(*args, mode=mode, **opts)
    rep = compare_grads(want, got, lanes=args[4])
    assert rep["ok"], rep


@pytest.mark.parametrize("T", [652, 2000])  # shared-memory table, global atomics
def test_scatter_rows_kernel_matches_plain(card, T):
    g = torch.Generator(device="cuda").manual_seed(T)
    R = 100_000
    idx = torch.randint(-1, T, (R,), device="cuda", generator=g, dtype=torch.int32)
    idx[:20_000] = 7  # a hot row
    dvals = torch.randn(48, R, device="cuda", generator=g)
    before = S.scatter_rows.launches
    got = S.scatter_rows(idx, dvals, T)
    torch.cuda.synchronize()
    assert S.scatter_rows.launches == before + 1
    # Against the exact sums: the plain f32 index_add_ adds with atomics
    # in no fixed order too.
    want = S.scatter_rows_ref(idx, dvals.double(), T)
    rep = compare_scatter(want, got, S.scatter_rows_ref(idx, dvals.double().abs(), T))
    assert rep["ok"], rep


def test_gradient_render_kernels_match_plain_path(card):
    scene, camera, _ = card
    config = TraceConfig(max_depth=7)
    loss_fn = G.make_loss_fn(scene, camera, torch.zeros(48, 64, 3, device="cuda"),
                             width=64, height=48, spp=1, config=config)
    params = G.split_params(scene, ("mat_kd", "mat_ka", "vertices"))
    counts = (F.mega_segment.launches, F.segment_backward.launches, S.scatter_rows.launches)
    loss, got = G.value_and_grad(loss_fn, params, make_key(4))
    assert (F.mega_segment.launches, F.segment_backward.launches,
            S.scatter_rows.launches) == tuple(c + 8 for c in counts)
    with plain_kernels():
        loss_ref, want = G.value_and_grad(loss_fn, params, make_key(4))
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-5)
    rep = compare_param_grads(want, got, 1e-4)
    assert rep["ok"], rep
    assert float(got["vertices"].abs().max()) == 0.0


def test_gradient_wrappers_refuse_bad_inputs_on_card(card):
    _, camera, rows = card
    _, args = _backward_args(camera, rows, "fixed", [0.0, 0.0, 0.0])
    before = (F.segment_backward.launches, S.scatter_rows.launches)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError, match="on"):
        F.segment_backward(*bad)
    bad = list(args)
    bad[4] = args[4].float()
    with pytest.raises(TypeError, match="bool"):
        F.segment_backward(*bad)
    bad = list(args)
    bad[6] = args[6][:33]
    with pytest.raises(ValueError, match="full"):
        F.segment_backward(*bad)
    idx = torch.zeros(10, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        S.scatter_rows(idx.long(), torch.zeros(48, 10, device="cuda"), 4)
    with pytest.raises(ValueError, match="48"):
        S.scatter_rows(idx, torch.zeros(10, 48, device="cuda"), 4)
    with pytest.raises(ValueError, match="on"):
        S.scatter_rows(idx.cpu(), torch.zeros(48, 10, device="cuda"), 4)
    assert (F.segment_backward.launches, S.scatter_rows.launches) == before


def _lane_flags(R, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.tensor([[0.3], [0.5], [0.2]], device="cuda")
    return (torch.rand(3, R, device="cuda", generator=g) < p).float()


@pytest.mark.parametrize("mode", ["fixed", "rr"])
def test_lane_flag_kernel_matches_plain_on_card(card, mode):
    _, camera, rows = card
    args = list(_camera_args(camera, rows, [0.0, 0.0, 0.0]))
    out = F.mega_segment(*args)  # a first-bounce wavefront
    args[1:6] = [out[1], out[2], out[3], out[4], out[5] > 0]
    args[9] = _lane_flags(64 * 48, seed=len(mode))
    before = F.mega_segment.launches
    got = F.mega_segment(*args, mode=mode)
    torch.cuda.synchronize()
    assert F.mega_segment.launches == before + 1
    want = F.mega_segment_ref(*args, mode=mode)
    rep = compare_segment(want, got, live=args[5], rows=rows, pos=args[1], dir_=args[2])
    assert rep["ok"], rep


@pytest.fixture(scope="module")
def bunny_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    scene, camera = bunny.bunny_scene(subdiv=3, width=64, height=48, device="cuda")
    return scene, camera, scene_tables(scene, TraceConfig(intersector="traverse"))


def _waves(camera, rows):
    """The 64x48 camera wavefront and its first bounce (with dead lanes)."""
    args = list(_camera_args(camera, rows, [0.0, 0.0, 0.0]))
    out = F.mega_segment_ref(*args)
    # The plain outputs may be strided views; the kernels take contiguous tensors.
    return [tuple(x.contiguous() for x in wave)
            for wave in (args[1:6], (out[1], out[2], out[3], out[4], out[5] > 0))]


def test_traverse_kernel_matches_plain_on_card(bunny_card):
    _, camera, tables = bunny_card
    for pos, dir_, _, _, live in _waves(camera, tables.rows):
        nt = -(-pos.shape[1] // TW.RAY_TILE)
        visits = torch.zeros(2, nt, dtype=torch.int32, device="cuda")
        before = TW.traverse_select.launches
        got = TW.traverse_select(tables.rows, tables.clo, tables.chi, pos, dir_, live,
                                 visits=visits)
        torch.cuda.synchronize()
        assert TW.traverse_select.launches == before + 1
        want = TW.traverse_select_ref(tables.rows, tables.clo, tables.chi, pos, dir_, live)
        rep = compare_winners(got, want, live=live, rows=tables.rows, pos=pos, dir_=dir_)
        assert rep["ok"], rep
        v = visits.cpu().numpy()
        assert (v[1] <= v[0]).all() and v[0].max() <= tables.clo.shape[0]


@pytest.mark.parametrize("lane", [False, True], ids=["B6", "B6l"])
def test_rows_segment_kernel_matches_plain_on_card(bunny_card, lane):
    _, camera, tables = bunny_card
    pos, dir_, tput, res, live = _waves(camera, tables.rows)[1]
    R = pos.shape[1]
    idx = TW.traverse_select_ref(tables.rows, tables.clo, tables.chi, pos, dir_, live)
    key = make_key(6)
    u1, u2, urr = (stream_uniform(key, s, R, "cuda") for s in (0, 1, 3))
    flags = _lane_flags(R, seed=3) if lane else \
        torch.tensor([[0.0], [1.0], [0.0]], device="cuda")
    args = (tables.rows, idx, pos, dir_, tput, res, live, u1, u2, urr, flags)
    for mode in ("fixed", "rr"):
        before = F.rows_segment.launches
        got = F.rows_segment(*args, mode=mode)
        torch.cuda.synchronize()
        assert F.rows_segment.launches == before + 1
        want = F.rows_segment_ref(*args, mode=mode)
        rep = compare_segment((idx, *want), (idx, *got), live=live, rows=tables.rows,
                              pos=pos, dir_=dir_)
        assert rep["ok"], rep


def test_traverse_render_on_card_matches_cpu_plain_path(bunny_card):
    scene, camera, _ = bunny_card
    config = TraceConfig(max_depth=3, intersector="traverse", ray_sort=True)
    got = render_sample_batch(scene, camera, make_key(2), 64, 48, config)
    want = render_sample_batch(scene.to("cpu"), camera.to("cpu"), make_key(2), 64, 48,
                               config)
    rep = compare_images(got, want)
    assert rep["ok"], rep


@pytest.mark.parametrize("intersector", ["megakernel", "traverse"])
def test_regen_on_card_matches_cpu_plain_path(card, intersector):
    scene, camera, _ = card
    config = TraceConfig(mode="rr", rr_depth=2, illum=1.0, intersector=intersector)
    launches = (F.mega_segment.launches, F.rows_segment.launches)
    got = render_regen_batch(scene, camera, make_key(5), 64, 48, 2, config)
    assert (F.mega_segment.launches, F.rows_segment.launches) != launches
    want = render_regen_batch(scene.to("cpu"), camera.to("cpu"), make_key(5), 64, 48, 2,
                              config)
    rep = compare_images(got, want)
    assert rep["ok"], rep


def test_traverse_gradient_render_kernels_match_plain_path(bunny_card):
    scene, camera, _ = bunny_card
    config = TraceConfig(max_depth=3, intersector="traverse", ray_sort=True)
    loss_fn = G.make_loss_fn(scene, camera, torch.zeros(48, 64, 3, device="cuda"),
                             width=64, height=48, spp=1, config=config)
    params = G.split_params(scene, ("mat_kd", "mat_ka", "vertices"))
    counts = (TW.traverse_select.launches, F.rows_segment.launches,
              F.segment_backward.launches, S.scatter_rows.launches)
    loss, got = G.value_and_grad(loss_fn, params, make_key(4))
    assert (TW.traverse_select.launches, F.rows_segment.launches,
            F.segment_backward.launches, S.scatter_rows.launches) == \
        tuple(c + 4 for c in counts)
    with plain_kernels():
        loss_ref, want = G.value_and_grad(loss_fn, params, make_key(4))
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-5)
    rep = compare_param_grads(want, got, 1e-4)
    assert rep["ok"], rep


def test_traverse_wrappers_refuse_bad_inputs_on_card(bunny_card):
    _, camera, tables = bunny_card
    pos, dir_, tput, res, live = _waves(camera, tables.rows)[0]
    before = (TW.traverse_select.launches, F.rows_segment.launches)
    with pytest.raises(TypeError, match="live"):
        TW.traverse_select(tables.rows, tables.clo, tables.chi, pos, dir_, live.float())
    with pytest.raises(ValueError, match="chunk boxes"):
        TW.traverse_select(tables.rows, tables.clo[:-1], tables.chi[:-1], pos, dir_, live)
    with pytest.raises(ValueError, match="on"):
        TW.traverse_select(tables.rows.cpu(), tables.clo, tables.chi, pos, dir_, live)
    idx = torch.zeros(pos.shape[1], dtype=torch.int64, device="cuda")
    u = torch.zeros(pos.shape[1], device="cuda")
    with pytest.raises(ValueError, match="int32"):
        F.rows_segment(tables.rows, idx, pos, dir_, tput, res, live, u, u, u,
                       torch.zeros(3, 1, device="cuda"))
    with pytest.raises(ValueError, match="flags"):
        F.rows_segment(tables.rows, idx.int(), pos, dir_, tput, res, live, u, u, u,
                       torch.zeros(3, 7, device="cuda"))
    assert (TW.traverse_select.launches, F.rows_segment.launches) == before


@pytest.fixture(scope="module")
def glossy_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    scene, camera = glossy.glossy_steps(width=64, height=48, device="cuda")
    return scene, camera, scene_tables(scene, TraceConfig(chunk_cull=True))


@pytest.mark.parametrize("lane", [False, True], ids=["B1c", "B1c_lane_flags"])
def test_cull_kernel_matches_plain_on_card(glossy_card, lane):
    _, camera, tables = glossy_card
    for pos, dir_, tput, res, live in _waves(camera, tables.rows):
        R = pos.shape[1]
        key = make_key(9)
        u1, u2, urr = (stream_uniform(key, s, R, "cuda") for s in (0, 1, 3))
        flags = _lane_flags(R, seed=5) if lane else torch.tensor([[0.0], [1.0], [0.0]],
                                                                  device="cuda")
        args = (tables.rows, pos, dir_, tput, res, live, u1, u2, urr, flags)
        for mode in ("fixed", "rr"):
            tested = torch.zeros(-(-R // 128), dtype=torch.int32, device="cuda")
            before = (F.mega_segment.launches, F.mega_segment.cull_launches)
            got = F.mega_segment(*args, mode=mode, tested=tested, **tables.cull_boxes)
            torch.cuda.synchronize()
            assert (F.mega_segment.launches, F.mega_segment.cull_launches) == \
                (before[0] + 1, before[1] + 1)
            want = F.mega_segment_ref(*args, mode=mode)
            rep = compare_segment(want, got, live=live, rows=tables.rows, pos=pos, dir_=dir_)
            assert rep["ok"], rep
            t = tested.cpu()
            assert t.max() <= tables.clo.shape[0] and t.float().mean() < tables.clo.shape[0]


@pytest.mark.parametrize("cull", [False, True], ids=["B4", "B4c"])
def test_nearest_shade_kernel_matches_plain_on_card(card, glossy_card, cull):
    cases = [(card[1], card[2], {}),
             (glossy_card[1], glossy_card[2].rows if cull else F.pack_rows_full(glossy_card[0]),
              glossy_card[2].cull_boxes if cull else {})]
    if cull:
        cases = cases[1:]
    for camera, rows, boxes in cases:
        for pos, dir_, _, _, live in _waves(camera, rows):
            before = (NS.nearest_shade_full.launches, NS.nearest_shade_full.cull_launches)
            got = NS.nearest_shade_full(rows, pos, dir_, live, **boxes)
            torch.cuda.synchronize()
            assert (NS.nearest_shade_full.launches, NS.nearest_shade_full.cull_launches) == \
                (before[0] + 1, before[1] + cull)
            want = NS.nearest_shade_full_ref(rows, pos, dir_, live)
            rep = compare_shade(got, want, live=live, rows=rows, pos=pos, dir_=dir_)
            assert rep["ok"], rep


def test_nearest_triangle_kernel_matches_plain_on_card(card, glossy_card):
    for scene, camera in (card[:2], glossy_card[:2]):
        rows = F.pack_rows_full(scene)
        geom = rows[:, :12].contiguous()
        for pos, dir_, _, _, _ in _waves(camera, rows):
            before = NS.nearest_triangle.launches
            got = NS.nearest_triangle(geom, pos, dir_)
            torch.cuda.synchronize()
            assert NS.nearest_triangle.launches == before + 1
            want = NS.nearest_triangle_ref(geom, pos, dir_)
            rep = compare_winners(got, want, live=torch.ones_like(got, dtype=torch.bool),
                                  rows=rows, pos=pos, dir_=dir_)
            assert rep["ok"], rep


@pytest.mark.parametrize("kw", [dict(whole_segment=False), dict(intersector="fused"),
                                dict(chunk_cull=True), dict(chunk_cull=True, ray_sort=True),
                                dict(whole_segment=False, chunk_cull=True)],
                         ids=["split", "fused", "cull", "cull_sort", "split_cull"])
def test_split_and_cull_renders_on_card_match_cpu_plain_path(glossy_card, kw):
    scene, camera, _ = glossy_card
    config = TraceConfig(max_depth=3, **kw)
    counts = (F.mega_segment.cull_launches, NS.nearest_shade_full.launches,
              NS.nearest_triangle.launches)
    got = render_sample_batch(scene, camera, make_key(2), 64, 48, config)
    assert (F.mega_segment.cull_launches, NS.nearest_shade_full.launches,
            NS.nearest_triangle.launches) != counts
    want = render_sample_batch(scene.to("cpu"), camera.to("cpu"), make_key(2), 64, 48, config)
    rep = compare_images(got, want)
    assert rep["ok"], rep


@pytest.mark.parametrize("intersector", ["megakernel", "fused"])
def test_split_gradient_kernels_match_plain_path(card, intersector):
    scene, camera, _ = card
    config = TraceConfig(max_depth=3, intersector=intersector, whole_segment=False)
    loss_fn = G.make_loss_fn(scene, camera, torch.zeros(48, 64, 3, device="cuda"),
                             width=64, height=48, spp=1, config=config)
    params = G.split_params(scene, ("mat_kd", "mat_ka", "vertices"))
    counts = (NS.nearest_shade_full.launches, NS.nearest_triangle.launches,
              S.scatter_rows.launches)
    loss, got = G.value_and_grad(loss_fn, params, make_key(4))
    split = intersector == "megakernel"
    assert (NS.nearest_shade_full.launches, NS.nearest_triangle.launches,
            S.scatter_rows.launches) == (counts[0] + 4 * split, counts[1] + 4 * (not split),
                                         counts[2] + 4 * split)
    with plain_kernels():
        loss_ref, want = G.value_and_grad(loss_fn, params, make_key(4))
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-5)
    rep = compare_param_grads(want, got, 1e-4)
    assert rep["ok"], rep


def test_split_wrappers_refuse_bad_inputs_on_card(glossy_card):
    _, camera, tables = glossy_card
    pos, dir_, _, _, live = _waves(camera, tables.rows)[0]
    before = (NS.nearest_shade_full.launches, NS.nearest_triangle.launches,
              F.mega_segment.launches)
    with pytest.raises(TypeError, match="live"):
        NS.nearest_shade_full(tables.rows, pos, dir_, live.float())
    with pytest.raises(ValueError, match="chunk boxes"):
        NS.nearest_shade_full(tables.rows, pos, dir_, live, tables.clo[:-1], tables.chi[:-1])
    with pytest.raises(ValueError, match="chunk boxes"):
        F.mega_segment(tables.rows, pos, dir_, pos, pos, live, live.float(), live.float(),
                       live.float(), torch.zeros(3, 1, device="cuda"), clo=tables.clo.cpu(),
                       chi=tables.chi)
    with pytest.raises(ValueError, match=r"\[T, 12\]"):
        NS.nearest_triangle(tables.rows, pos, dir_)
    with pytest.raises(ValueError, match="contiguous"):
        NS.nearest_triangle(tables.rows[:, :12], pos, dir_)
    assert (NS.nearest_shade_full.launches, NS.nearest_triangle.launches,
            F.mega_segment.launches) == before


def _variant_calls(scene, perm, pos, dir_, live):
    """``{name: (entry, its row table)}`` of B8-B11 on one scene padded to
    a multiple of 128 triangles (``perm`` its Morton order)."""
    pad = -scene.num_triangles % 128
    a, b, c = (torch.cat([x, torch.zeros(pad, 3, device="cuda")]) for x in
               scene.triangle_vertices())
    valid = torch.cat([scene.tri_valid, torch.zeros(pad, dtype=torch.bool, device="cuda")])
    perm = torch.cat([perm, torch.arange(scene.num_triangles, len(valid), device="cuda")])
    m, m_a = triangle_transforms(a, b, c)
    table = torch.cat([NV.pack_shading_table(scene), torch.zeros(pad, 32, device="cuda")])
    w = NV.pack_transforms(m, m_a, valid)
    geom = NV._geometry(w).contiguous()
    wp = NV.pack_transforms(m[perm], m_a[perm], valid[perm])
    tp = table[perm].contiguous()
    ws_c = NV.pack_transforms_stream(m[perm], m_a[perm], valid[perm], 128)
    boxes = chunk_aabbs_padded(a, b, c, valid, perm, 128)
    rows, rows_p = NV._rows(geom, table), NV._rows(NV._geometry(wp), tp)
    return {
        "B8": (lambda: NV.nearest_shade(w, table, pos, dir_), rows),
        "B9": (lambda: NV.nearest_shade2(NV.pack_transforms_fused(m, m_a, valid, 128), geom,
                                         table, pos, dir_, t_chunk=128), rows),
        "B10": (lambda: NV.nearest_shade_streamed(NV.pack_transforms_stream(m, m_a, valid, 256),
                                                  geom, table, pos, dir_, live, t_chunk=256),
                rows),
        "B10c": (lambda: NV.nearest_shade_streamed(ws_c, geom[perm], tp, pos, dir_, live,
                                                   *boxes, t_chunk=128, cull=True), rows_p),
        "B11": (lambda: NV.nearest_shade_culled(wp, tp, *chunk_aabbs(a, b, c, valid, perm, 128),
                                                pos, dir_, live), rows_p),
        # Boxes of 352 triangles, which tile_boxes regrids to B4c's tiles of 128.
        "B11w": (lambda: NV.nearest_shade_culled(wp, tp, *chunk_aabbs(a, b, c, valid, perm, 352),
                                                 pos, dir_, live), rows_p),
    }


@pytest.mark.parametrize("name", ["B8", "B9", "B10", "B10c", "B11", "B11w"])
def test_selection_entries_match_plain_on_card(glossy_card, name):
    """B8-B11 launch B4 (B4c for the culling entries), count their
    launches and agree with their plain versions (``testing.compare_shade``)
    on the glossy camera wavefront and its first bounce with dead lanes."""
    scene, camera, tables = glossy_card
    entry = {"B8": NV.nearest_shade, "B9": NV.nearest_shade2, "B10": NV.nearest_shade_streamed,
             "B10c": NV.nearest_shade_streamed, "B11": NV.nearest_shade_culled,
             "B11w": NV.nearest_shade_culled}[name]
    for pos, dir_, _, _, live in _waves(camera, tables.rows):
        call, rows = _variant_calls(scene, tables.perm, pos, dir_, live)[name]
        before = (entry.launches, NS.nearest_shade_full.launches,
                  NS.nearest_shade_full.cull_launches)
        got = call()
        torch.cuda.synchronize()
        cull = name in ("B10c", "B11", "B11w")
        assert (entry.launches, NS.nearest_shade_full.launches,
                NS.nearest_shade_full.cull_launches) == (before[0] + 1, before[1] + 1,
                                                         before[2] + cull)
        with plain_kernels():
            want = call()
        every = name in ("B8", "B9")  # these entries have no live mask
        lanes = torch.ones_like(live) if every else live
        rep = compare_shade(got, want, live=lanes, rows=rows, pos=pos, dir_=dir_)
        assert rep["ok"], rep


@pytest.mark.parametrize("variant", SM.VARIANTS)
def test_selection_micro_matches_plain_on_card(card, variant):
    g = torch.Generator(device="cuda").manual_seed(3)
    ws = torch.randn(SM.K, 6 * 768, device="cuda", generator=g).to(torch.bfloat16)
    rays = torch.randn(SM.K, 5000, device="cuda", generator=g).to(torch.bfloat16)
    before = SM.selection_micro.launches[variant]
    got = SM.selection_micro(ws, rays, 256, variant)
    torch.cuda.synchronize()
    assert SM.selection_micro.launches[variant] == before + 1
    assert torch.equal(got, SM.selection_micro_ref(ws, rays, 256, variant))
    with pytest.raises(ValueError, match="contiguous"):
        SM.selection_micro(ws, rays[:, ::2], 256, variant)
    assert SM.selection_micro.launches[variant] == before + 1


def test_selection_epilogues_match_plain_on_card(card):
    g = torch.Generator(device="cuda").manual_seed(4)
    p_all = torch.randn(6 * 768, 3000, device="cuda", generator=g)
    before = SM.epilogue_only.launches
    got = SM.epilogue_only(p_all, 256)
    torch.cuda.synchronize()
    assert SM.epilogue_only.launches == before + 1
    assert torch.equal(got, SM.epilogue_only_ref(p_all, 256))
    p_blk = torch.randn(6 * 256, 512, device="cuda", generator=g)
    before = SM.epilogue_shared.launches
    got = SM.epilogue_shared(p_blk, 768, 3000)
    torch.cuda.synchronize()
    assert SM.epilogue_shared.launches == before + 1
    assert torch.equal(got, SM.epilogue_shared_ref(p_blk, 768, 3000))


def test_kdtree_render_on_card_matches_cpu(card):
    scene, camera, _ = card
    config = TraceConfig(max_depth=3, intersector="kdtree")
    got = render_sample_batch(scene, camera, make_key(2), 64, 48, config)
    want = render_sample_batch(scene.to("cpu"), camera.to("cpu"), make_key(2), 64, 48, config)
    rep = compare_images(got, want)
    assert rep["ok"], rep
