"""The port's CUDA kernels on the card (the segment forward with scalar
and per-lane flags and with chunk culling, its vjp, the row scatter, the
traversal walk and its tables, the segment from known winners, the split
path's nearest hit with and without culling and the fused intersector's
index, the superseded selection entries over it, the selection
microkernels, the uniform draws): each
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
from montecarlopathtracer_tpu_torch.ops import cuda_build
from montecarlopathtracer_tpu_torch.ops import cull as CU
from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS
from montecarlopathtracer_tpu_torch.ops import nearest_variants as NV
from montecarlopathtracer_tpu_torch.ops import regen_pass as RP
from montecarlopathtracer_tpu_torch.ops import rng as RNG
from montecarlopathtracer_tpu_torch.ops import selection_micro as SM
from montecarlopathtracer_tpu_torch.ops import scatter_rows as S
from montecarlopathtracer_tpu_torch.ops import segment_fused as F
from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW
from montecarlopathtracer_tpu_torch.ops.intersect import triangle_transforms
from montecarlopathtracer_tpu_torch.ops.morton import (
    chunk_aabbs,
    chunk_aabbs_padded,
    morton_order,
)
from montecarlopathtracer_tpu_torch.ops.rng import make_key, stream_uniform
from montecarlopathtracer_tpu_torch.render.integrator import (
    TraceConfig,
    render_rows_planar,
    render_sample_batch,
    scene_tables,
)
from montecarlopathtracer_tpu_torch.render.regen import render_regen_batch, render_regen_planar
from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
from montecarlopathtracer_tpu_torch.scene.camera import Camera
from montecarlopathtracer_tpu_torch.testing import (
    HARD_SOUPS,
    cap_torch_threads,
    compare_grads,
    compare_images,
    compare_micro,
    compare_param_grads,
    compare_scatter,
    compare_segment,
    compare_shade,
    compare_winners,
    hard_soup,
    plain_kernels,
    program_spans,
    tie_soup,
)
from montecarlopathtracer_tpu_torch.utils import profiling

cap_torch_threads()

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
    before = profiling.launches()
    got = F.mega_segment(*args, mode=mode)
    torch.cuda.synchronize()
    assert profiling.launches() - before == {"B1": 1}
    want = F.mega_segment_ref(*args, mode=mode)
    rep = compare_segment(want, got, live=args[5], rows=rows, pos=args[1], dir_=args[2])
    assert rep["ok"], rep


def test_wrapper_refuses_bad_inputs_on_card(card):
    _, camera, rows = card
    args = list(_camera_args(camera, rows, [0.0, 0.0, 0.0]))
    before = profiling.launches()
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
    assert profiling.launches() - before == {}


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
    before = profiling.launches()
    got = F.segment_backward(*args, mode=mode, **opts)
    torch.cuda.synchronize()
    assert profiling.launches() - before == {"B2": 1}
    want = F.segment_backward_ref(*args, mode=mode, **opts)
    rep = compare_grads(want, got, lanes=args[4])
    assert rep["ok"], rep


def _assert_b2_on_rows(rows, idx, args, mode, opts):
    """B2 (``segment_backward_rows`` on ``rows`` and ``idx``) against its
    plain version (``testing.compare_grads``, as the other B2 tests hold
    it), and ``segment_backward`` on ``gather_rows(rows, idx)``, which
    runs the same kernel over the gathered copy, bit-equal to it; one B2
    launch each. Returns B2's outputs."""
    state, rest = args[:5], args[7:]
    before = profiling.launches()
    got = F.segment_backward_rows(*state, rows, idx, *rest, mode=mode, **opts)
    same = F.segment_backward(*state, idx >= 0, F.gather_rows(rows, idx), *rest, mode=mode,
                              **opts)
    torch.cuda.synchronize()
    assert profiling.launches() - before == {"B2": 2}
    want = F.segment_backward_rows_ref(*state, rows, idx, *rest, mode=mode, **opts)
    rep = compare_grads(want, got, lanes=state[4])
    assert rep["ok"], rep
    for name, g, w in zip(("d_pos", "d_dir", "d_tput", "d_res", "d_full"), same, got):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name
    return got


@pytest.mark.parametrize("mode,flags,opts", [
    ("fixed", [0.0, 0.0, 0.0], {}), ("fixed", [1.0, 0.0, 0.0], {}),
    ("rr", [0.0, 1.0, 0.0], {"tied": True}), ("rr", [0.0, 0.0, 1.0], {}),
    ("fixed", [0.0, 0.0, 0.0], {"phong_model": "phong"}),
])
def test_indexed_segment_backward_is_bit_equal_to_gathered(card, mode, flags, opts):
    """A second-bounce wavefront (lanes that are not live among them), a
    lane in seven made a miss on top of the wavefront's own."""
    _, camera, rows = card
    opts = dict(opts)
    tput = torch.full((3, 64 * 48), 0.6, device="cuda") if opts.pop("tied", False) else None
    idx, args = _backward_args(camera, rows, mode, flags, tput)
    idx = idx.clone()
    idx[::7] = -1
    act = args[4]
    assert bool((~act).any()) and bool((act & (idx < 0)).any()) and bool((act & (idx >= 0)).any())
    got = _assert_b2_on_rows(rows, idx, args, mode, opts)
    if flags[0] == 0.0 and flags[2] == 0.0:  # lanes go on: the geometry rows are read
        assert float(got[4][:12].abs().max()) > 0.0


@pytest.mark.parametrize("T", [32, 81_931])
def test_indexed_segment_backward_reads_any_table(card, T):
    """Tables of T rows (T = 32, the benchmark's box; 81,931, larger than
    L1 and not a multiple of 4) holding a scene's rows at seeded places
    and copies of them elsewhere; each lane's winner moved to its row's
    place. T = 32 takes the box without spheres (12 rows), 81,931 the
    card scene's 652."""
    _, camera, card_rows = card
    if T == 32:
        scene, _ = cornell.cornell_box(width=64, height=48, device="cuda")
        rows = F.pack_rows_full(scene)
    else:
        rows = card_rows
    idx, args = _backward_args(camera, rows, "rr", [0.0, 1.0, 0.0])
    g = torch.Generator(device="cuda").manual_seed(T)
    T0 = rows.shape[0]
    place = torch.randperm(T, device="cuda", generator=g)[:T0]
    fill = torch.randint(0, T0, (T,), device="cuda", generator=g)
    fill[place] = torch.arange(T0, device="cuda")
    table = rows[fill].contiguous()
    moved = torch.where(idx >= 0, place[idx.clamp_min(0).long()], -1).to(torch.int32)
    hit = idx >= 0
    assert torch.equal(F.gather_rows(table, moved)[:, hit], F.gather_rows(rows, idx)[:, hit])
    assert bool((moved >= T0).any()) and bool((moved < 0).any())
    _assert_b2_on_rows(table, moved, args, "rr", {})


def _scatter_inputs(R, T, hot, seed):
    """Seeded rays: about a tenth with idx = -1, ``hot`` of them into row 7
    (when T > 7), the rest uniform over the rows; N(0, 1) cotangents."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    idx = torch.randint(0, T, (R,), device="cuda", generator=g, dtype=torch.int32)
    idx[torch.rand(R, device="cuda", generator=g) < 0.1] = -1
    if T > 7:
        idx[:hot] = 7
    return idx, torch.randn(48, R, device="cuda", generator=g)


@pytest.mark.parametrize("R,T,hot", [
    (100_000, 652, 36_063), (100_000, 2000, 20_000), (262_144, 5000, 36_063),
    (262_144, 81_932, 30_000), (0, 5, 0), (1, 1, 0), (37, 3, 0), (8193, 1, 0),
    (70_000, 1025, 0),
], ids=["T652", "T2000", "T5000", "T81932", "R0", "R1", "R37", "R8193-T1", "T1025"])
def test_scatter_rows_kernel_matches_plain(card, R, T, hot):
    idx, dvals = _scatter_inputs(R, T, hot, seed=T + R)
    before = profiling.launches()
    got = S.scatter_rows(idx, dvals, T)
    torch.cuda.synchronize()
    assert profiling.launches() - before == _b3_launches(T)
    # Against the exact sums: the plain f32 index_add_ adds with atomics
    # in no fixed order.
    want = S.scatter_rows_ref(idx, dvals.double(), T)
    rep = compare_scatter(want, got, S.scatter_rows_ref(idx, dvals.double().abs(), T))
    assert rep["ok"], rep


@pytest.mark.parametrize("T,R", [(652, 262_144), (5000, 262_144), (81_932, 262_144),
                                 (32, 480_000)], ids=["652", "5000", "81932", "32"])
def test_scatter_rows_kernel_is_deterministic(card, T, R):
    """Two calls give bit-equal tables, and every entry is written: the
    memory the table is allocated from is filled with NaN before each
    call. T = 32 at R = 480,000 is the inverse cell's call, on the small
    path."""
    idx, dvals = _scatter_inputs(R, T, 36_063, seed=T)
    tables = []
    for _ in range(2):
        poison = torch.full((T * 48 * 4,), float("nan"), device="cuda")
        del poison
        tables.append(S.scatter_rows(idx, dvals, T))
        torch.cuda.synchronize()
    assert bool(torch.isfinite(tables[0]).all())
    assert torch.equal(tables[0], tables[1])
    assert int((idx == 7).sum()) >= 30_000 and bool((idx < 0).any())


def _b3_launches(T):
    """The launches one B3 call at T rows counts: B3, and B3s too on the
    small-table path."""
    return {"B3": 1, "B3s": 1} if T <= S.T_SMALL else {"B3": 1}


def _small_inputs(R, T, seed):
    """Seeded rays for the small path: at least 3/4 in a hot row (the
    first bounce's wall), an eighth with idx = -1 and a sixteenth out of
    range either way (below -1, at or above T), the rest uniform over
    the rows; N(0, 1) cotangents on every column."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    idx = torch.randint(0, T, (R,), device="cuda", generator=g, dtype=torch.int32)
    u = torch.rand(R, device="cuda", generator=g)
    idx[u < 0.78] = T // 2
    idx[(u >= 0.78) & (u < 0.78 + 1 / 8)] = -1
    far = torch.tensor([T, T + 5, -2, -(1 << 30), (1 << 31) - 1], device="cuda",
                       dtype=torch.int32)
    odd = u >= 1 - 1 / 16
    idx[odd] = far[torch.randint(0, len(far), (int(odd.sum()),), device="cuda", generator=g)]
    return idx, torch.randn(48, R, device="cuda", generator=g)


@pytest.mark.parametrize("R", [0, 1, 37, 8193, 480_000])
@pytest.mark.parametrize("T", [1, 3, 32, S.T_SMALL, S.T_SMALL + 1])
def test_scatter_rows_small_path_matches_exact(card, T, R):
    """B3 at the small path's sizes and just past its bound, against the
    exact (f64) sums by ``compare_scatter``: indices outside [0, T) add
    nothing, a hot row holds most rays, and the launch table shows which
    path served the call."""
    idx, dvals = _small_inputs(R, T, seed=7 * T + R)
    before = profiling.launches()
    got = S.scatter_rows(idx, dvals, T)
    torch.cuda.synchronize()
    assert profiling.launches() - before == _b3_launches(T)
    keep = (idx >= 0) & (idx < T)
    kept = torch.where(keep, idx, -1)
    want = S.scatter_rows_ref(kept, dvals.double(), T)
    rep = compare_scatter(want, got, S.scatter_rows_ref(kept, dvals.double().abs(), T))
    assert rep["ok"], rep
    if R >= 8193:
        assert int((idx == T // 2).sum()) >= 0.75 * R and not bool(keep.all())


def test_scatter_rows_paths_agree_at_32_rows(card):
    """The small path and the sort path on the same inputs of the inverse
    cell's shape (T = 32, R = 480,000): each within ``compare_scatter`` of
    the exact sums and of the other."""
    idx, dvals = _small_inputs(480_000, 32, seed=32)
    before = profiling.launches()
    small = S._scatter_rows_cuda(idx, dvals, 32, small=True)
    sort = S._scatter_rows_cuda(idx, dvals, 32, small=False)
    torch.cuda.synchronize()
    assert profiling.launches() - before == {"B3": 2, "B3s": 1}
    kept = torch.where((idx >= 0) & (idx < 32), idx, -1)
    want = S.scatter_rows_ref(kept, dvals.double(), 32)
    bound = S.scatter_rows_ref(kept, dvals.double().abs(), 32)
    for got in (small, sort):
        rep = compare_scatter(want, got, bound)
        assert rep["ok"], rep
    rep = compare_scatter(sort.double(), small, bound)
    assert rep["ok"], rep


def test_gradient_render_kernels_match_plain_path(card):
    scene, camera, _ = card
    config = TraceConfig(max_depth=7)
    loss_fn = G.make_loss_fn(scene, camera, torch.zeros(48, 64, 3, device="cuda"),
                             width=64, height=48, spp=1, config=config)
    params = G.split_params(scene, ("mat_kd", "mat_ka", "vertices"))
    before = profiling.launches()
    loss, got = G.value_and_grad(loss_fn, params, make_key(4))
    made = profiling.launches() - before
    assert {k: made[k] for k in ("B1", "B2", "B3")} == dict.fromkeys(("B1", "B2", "B3"), 8)
    with plain_kernels():
        loss_ref, want = G.value_and_grad(loss_fn, params, make_key(4))
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-5)
    rep = compare_param_grads(want, got, 1e-4)
    assert rep["ok"], rep
    assert float(got["vertices"].abs().max()) == 0.0


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("R", [480_000, 1_048_576])
def test_rng_kernel_is_bit_equal_to_plain_on_card(card, R, k):
    """rng.cu: one launch per call, the plain version's bits for every
    stream, a contiguous row per stream; ``stream_uniform`` is its row."""
    key = RNG.fold_in(make_key(9), 2)
    ids = (0, (1 << 30) + 673, 3)[:k]
    before = profiling.launches()
    got = RNG.stream_uniforms(key, ids, R, "cuda")
    torch.cuda.synchronize()
    assert profiling.launches() - before == {"RNG": 1}
    assert got.shape == (k, R) and got.dtype == torch.float32
    assert all(row.is_contiguous() for row in got)
    want = RNG.stream_uniforms_ref(key, ids, R, "cuda")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    row = RNG.stream_uniform(key, ids[-1], R, "cuda")
    assert torch.equal(row.view(torch.int32), want[-1].view(torch.int32))
    assert profiling.launches() - before == {"RNG": 2}


def test_rng_wrapper_refuses_on_card(card):
    before = profiling.launches()
    with pytest.raises(ValueError, match="streams"):
        RNG.stream_uniforms(make_key(1), range(5), 16, "cuda")
    with pytest.raises(ValueError, match="2\\*\\*32"):
        RNG.stream_uniforms(make_key(1), (0,), 2**32, "cuda")
    assert profiling.launches() - before == {}


def test_render_under_plain_kernels_equals_kernel_render_on_card(card):
    """The kernel path's render (B1 and the RNG kernel) against the same
    render with every wrapper routed to its plain version, same key: the
    RNG launches only on the kernel path."""
    scene, camera, _ = card
    config = TraceConfig(max_depth=7, mode="rr", rr_depth=3, illum=1.0)
    before = profiling.launches()
    got = render_sample_batch(scene, camera, make_key(6), 64, 48, config)
    torch.cuda.synchronize()
    made = profiling.launches() - before
    assert (made["RNG"], made["B1"]) == (1 + config.num_segments, config.num_segments)
    with plain_kernels():
        want = render_sample_batch(scene, camera, make_key(6), 64, 48, config)
    assert profiling.launches() - before == made
    rep = compare_images(got, want)
    assert rep["ok"], rep


def test_gradient_wrappers_refuse_bad_inputs_on_card(card):
    _, camera, rows = card
    _, args = _backward_args(camera, rows, "fixed", [0.0, 0.0, 0.0])
    before = profiling.launches()
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
    # The entry through the index: idx's dtype and length, the table's
    # shape, dtype and layout.
    win = torch.zeros(args[0].shape[1], dtype=torch.int32, device="cuda")
    for rows_, idx_, err, match in (
            (rows, win.long(), ValueError, "int32"), (rows, win[:-1], ValueError, "idx"),
            (rows, win.cpu(), ValueError, "idx"),
            (rows[:, :47].contiguous(), win, ValueError, "48"),
            (rows.double(), win, TypeError, "float32"),
            (rows.T.contiguous().T, win, ValueError, "contiguous"),
            (rows.flatten()[1:1 + 48 * 10].view(10, 48), win, ValueError, "aligned"),
            (rows.cpu(), win, ValueError, "on")):
        with pytest.raises(err, match=match):
            F.segment_backward_rows(*args[:5], rows_, idx_, *args[7:])
    bad = list(args[:5])
    bad[4] = args[4].float()
    with pytest.raises(TypeError, match="bool"):
        F.segment_backward_rows(*bad, rows, win, *args[7:])
    idx = torch.zeros(10, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        S.scatter_rows(idx.long(), torch.zeros(48, 10, device="cuda"), 4)
    with pytest.raises(ValueError, match="48"):
        S.scatter_rows(idx, torch.zeros(10, 48, device="cuda"), 4)
    with pytest.raises(ValueError, match="on"):
        S.scatter_rows(idx.cpu(), torch.zeros(48, 10, device="cuda"), 4)
    with pytest.raises(ValueError, match="contiguous"):
        S.scatter_rows(idx, torch.zeros(10, 48, device="cuda").T, 4)
    with pytest.raises(ValueError, match="out of range"):
        S.scatter_rows(idx, torch.zeros(48, 10, device="cuda"), 0)
    assert profiling.launches() - before == {}


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
    before = profiling.launches()
    got = F.mega_segment(*args, mode=mode)
    torch.cuda.synchronize()
    assert profiling.launches() - before == {"B1l": 1}
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
    nleaf, P = -(-tables.rows.shape[0] // tables.walk.leaf), tables.walk.leaves
    for pos, dir_, _, _, live in _waves(camera, tables.rows):
        visits = torch.full((2, pos.shape[1]), -1, dtype=torch.int32, device="cuda")
        before = profiling.launches()
        got = TW.traverse_select(tables.rows, tables.clo, tables.chi, pos, dir_, live,
                                 tables=tables.walk, visits=visits)
        torch.cuda.synchronize()
        assert profiling.launches() - before == {"B5": 1}
        want = TW.traverse_select_ref(tables.rows, tables.clo, tables.chi, pos, dir_, live)
        rep = compare_winners(got, want, live=live, rows=tables.rows, pos=pos, dir_=dir_)
        assert rep["ok"], rep
        split = NS.nearest_shade_full(tables.rows, pos, dir_, live)[0]
        assert torch.equal(got, split)
        v = visits.cpu()
        assert (v[:, ~live.cpu()] == 0).all() and (v >= 0).all()
        assert v[0].max() < P and v[1].max() <= nleaf and (v[1][live.cpu()] >= 1).any()


def test_walk_tables_kernel_matches_plain_on_card(bunny_card):
    """B5's tables: the tree's boxes and the records' geometry bit-equal to
    the plain version; the spheres, ext and grow within 1e-5 of their
    scale (the kernel contracts FMAs), infinite exactly where the plain
    version's are."""
    _, _, tables = bunny_card
    before = profiling.launches()
    got = TW.walk_tables(tables.rows.detach(), tables.clo, tables.chi)
    torch.cuda.synchronize()
    assert profiling.launches() - before == {"B5t": 1}
    want = TW.walk_tables_ref(tables.rows.detach(), tables.clo, tables.chi)
    box = [0, 1, 2, 4, 5, 6]
    assert torch.equal(got.tree[:, box], want.tree[:, box])
    assert torch.equal(got.tri[:, 4:], want.tri[:, 4:])  # the geometry rows, copied
    fin = torch.isfinite(want.tri[:, 3])
    assert torch.equal(fin, torch.isfinite(got.tri[:, 3])) and fin.float().mean() > 0.99
    # Centers and radii to 1e-5 of |c| + K0; grow to 1e-5 of itself; ext (a
    # slack K0 - rho, computed by cancellation) to 1e-5 of the largest K0.
    x, y = got.tri[fin, :4], want.tri[fin, :4]
    scale = y[:, :3].norm(dim=1, keepdim=True) + y[:, 3:]
    assert ((x - y).abs() <= 1e-5 * scale).all(), float(((x - y).abs() / scale).max())
    assert ((got.tree[:, 3] - want.tree[:, 3]).abs() <= 1e-5 * y[:, 3].max()).all()
    assert torch.allclose(got.tree[:, 7], want.tree[:, 7], rtol=1e-5, atol=0.0)


def _tables_bits(got, old):
    return (torch.equal(got.tree.view(torch.int32), old.tree.view(torch.int32))
            and torch.equal(got.tri.view(torch.int32), old.tri.view(torch.int32)))


@pytest.mark.parametrize("which", ["bunny", "hard_soups"])
def test_walk_tables_one_launch_equals_earlier_build_on_card(card, which):
    """B5t, one launch of a warp per leaf: the earlier two-kernel build's
    bits (records and tree), its tree tree_ref over its own leaves bit for
    bit (the climb across blocks), its boxes and geometry
    walk_tables_ref's; on the subdivision-6 bunny (81,932 triangles, the
    render path's leaves of 32 and its chunks of 128) and on the hard
    soups in Morton order at T = 1, 20, 70, 700 and 1500."""
    if which == "bunny":
        scene, _ = bunny.bunny_scene(subdiv=6, width=64, height=48, device="cuda")
        t = scene_tables(scene, TraceConfig(intersector="traverse"))
        lo, hi, big = TW.walk_boxes(*scene.triangle_vertices(), scene.tri_valid, t.perm)
        assert t.rows.shape[0] == 81_932
        cases = [(t.rows.detach(), lo, hi, TW.LEAF, big),
                 (t.rows.detach(), t.clo, t.chi, TW.CHUNK, None)]
    else:
        cases = []
        for case in HARD_SOUPS:
            for T in (1, 20, 70, 700, 1500):
                verts, rows, _, _ = hard_soup(case, T, 8, seed=T, device="cuda")
                valid = torch.ones(T, dtype=torch.bool, device="cuda")
                perm = morton_order(*verts, valid)
                for leaf in (TW.LEAF, TW.CHUNK):
                    clo, chi = chunk_aabbs_padded(*verts, valid, perm, leaf)
                    cases.append((rows[perm].contiguous(), clo, chi, leaf, None))
    box = [0, 1, 2, 4, 5, 6]
    for rows, clo, chi, leaf, big in cases:
        before = profiling.launches()
        got = TW.walk_tables(rows, clo, chi, leaf, big)
        torch.cuda.synchronize()
        assert profiling.launches() - before == {"B5t": 1}
        old, _ = TW.walk_tables_split(rows, clo, chi, leaf, big)
        assert profiling.launches() - before == {"B5t": 1}
        assert _tables_bits(got, old)
        P, nc = got.leaves, clo.shape[0]
        ref = TW.tree_ref(clo, chi, got.tree[P:P + nc, 3], got.tree[P:P + nc, 7])
        assert torch.equal(got.tree.view(torch.int32), ref.view(torch.int32))
        want = TW.walk_tables_ref(rows, clo, chi, leaf, big)
        assert torch.equal(got.tree[:, box], want.tree[:, box])
        assert torch.equal(got.tri[:, 4:].view(torch.int32), want.tri[:, 4:].view(torch.int32))


def test_traverse_kernel_breaks_equal_t_ties_by_index(card):
    """On ``testing.tie_soup`` every winner has an exact copy at a larger
    index in a chunk that the walk enters first: B5 keeps the smaller
    index, as B4 and the plain version do."""
    _, rows, clo, chi, pos, dir_ = tie_soup("cuda", R=4096)
    live = torch.ones(pos.shape[1], dtype=torch.bool, device="cuda")
    got = TW.traverse_select(rows, clo, chi, pos, dir_, live)
    want = TW.traverse_select_ref(rows, clo, chi, pos, dir_, live)
    split = NS.nearest_shade_full(rows, pos, dir_, live)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, split)
    assert ((got >= 0) & (got < 64)).float().mean() > 0.9


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
        before = profiling.launches()
        got = F.rows_segment(*args, mode=mode)
        torch.cuda.synchronize()
        assert profiling.launches() - before == {"B6l" if lane else "B6": 1}
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
    before = profiling.launches()
    got = render_regen_batch(scene, camera, make_key(5), 64, 48, 2, config)
    made = profiling.launches() - before
    b1, b6 = made["B1"] + made["B1l"] + made["B1c"], made["B6"] + made["B6l"]
    if intersector == "megakernel":  # the pass kernel (B1r), no segment launch
        assert (made["B1r"], b1, b6) == (1, 0, 0)
    else:  # the host loop: the walk and the rows segment (B6l) per step
        assert (made["B1r"], b1) == (0, 0) and b6 > 0
    want = render_regen_batch(scene.to("cpu"), camera.to("cpu"), make_key(5), 64, 48, 2,
                              config)
    rep = compare_images(got, want)
    assert rep["ok"], rep


REGEN_PASS_CASES = {
    "cornell_rr": {},
    "cornell_fixed_band": {},
    "glossy_cull": dict(chunk_cull=True),
    # The glossy stage unculled: 1332 rows, above kWholeMax, so each step
    # runs select_two's ring of tiles inside the persistent loop.
    "glossy_ring": {},
}


@pytest.mark.parametrize("which", REGEN_PASS_CASES)
def test_regen_pass_kernel_equals_host_loop_on_card(card, which):
    """B1r (regen_pass.cu) against the host loop with B1l on the same
    tables and key: every lane's accum and lane_steps bit-equal, one
    launch and no B1l or draw; the counters add up (live lane-steps = the
    lanes' steps, slot-steps = block-steps x slots, no origin over the
    staged bound)."""
    w, h = 64, 48
    if which.startswith("glossy"):
        scene, camera = glossy.glossy_steps(width=w, height=h, device="cuda")
        kw = {"mode": "fixed", "max_depth": 3, **REGEN_PASS_CASES[which]}
        config, spp, band = TraceConfig(**kw), 3, {}
    else:
        scene, camera, _ = card
        rr = which != "cornell_fixed_band"
        config = (TraceConfig(mode="rr", rr_depth=2, illum=1.0) if rr
                  else TraceConfig(mode="fixed", max_depth=3))
        spp, band = (4, {}) if rr else (3, dict(y0=16, n_rows=16))
    tables = scene_tables(scene, config)
    T = tables.rows.shape[0]
    assert (T > 760 and not config.chunk_cull) == which.startswith("glossy_ring")  # kWholeMax
    key = make_key(17)
    before = profiling.launches()
    stats = {}
    got, steps = RP.regen_pass(tables, config, camera, key, w, h, spp, **band, stats=stats)
    torch.cuda.synchronize()
    cull = int(config.chunk_cull)
    assert profiling.launches() - before == {"B1rc" if cull else "B1r": 1}
    want, host_steps = RP.regen_pass_ref(tables, config, camera, key, w, h, spp, **band)
    assert torch.equal(got, want) and torch.equal(steps, host_steps)
    R = w * band.get("n_rows", h)
    assert steps.shape == (R,) and int(steps.max()) < RP.max_steps(spp, config)
    col = {name: int(v) for name, v in zip(RP.STATS, stats["counters"].cpu())}
    assert col["live_steps"] == int(steps.long().sum()) and col["overflow"] == 0
    assert col["slot_steps"] == col["block_steps"] * RP.slots_per_block(config)
    assert 0 < col["blocks"] <= stats["grid"]
    assert (stats["omax"] is None) == (cull == 1 or T > 760)
    with plain_kernels():
        plain, _ = RP.regen_pass(tables, config, camera, key, w, h, spp, **band)
    n = band.get("n_rows", h)
    rep = compare_images((got / spp).reshape(3, n, w).permute(1, 2, 0),
                         (plain / spp).reshape(3, n, w).permute(1, 2, 0))
    assert rep["ok"], rep


@pytest.mark.parametrize("which", ["cornell_rr", "glossy_cull"])
def test_regen_pass_kernel_with_an_order_is_bit_equal_on_card(card, which):
    """B1r (``cornell_rr``) and B1rc (``glossy_cull``) handing lanes out in
    an order (longest first by a pass's own ``lane_steps``, and that order
    reversed) give the unordered launch's accum and ``lane_steps`` bit for
    bit, and the host loop's; the live lane-steps stay the lanes' steps.
    ``longest_first`` syncs with nothing; a bad order is refused."""
    w, h = 64, 48
    if which == "glossy_cull":
        scene, camera = glossy.glossy_steps(width=w, height=h, device="cuda")
        config, spp = TraceConfig(mode="fixed", max_depth=3, chunk_cull=True), 16
    else:
        scene, camera, _ = card
        config, spp = TraceConfig(mode="rr", rr_depth=2, illum=1.0), 16
    tables, key = scene_tables(scene, config), make_key(34)
    want, want_steps = RP.regen_pass(tables, config, camera, key, w, h, spp)
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = RP.longest_first(want_steps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not torch.equal(first, torch.arange(w * h, dtype=torch.int32, device="cuda"))
    host, host_steps = RP.regen_pass_ref(tables, config, camera, key, w, h, spp)
    assert torch.equal(want, host) and torch.equal(want_steps, host_steps)
    for order in (first, first.flip(0).contiguous()):
        stats = {}
        with profiling.recording() as rec:
            got, steps = RP.regen_pass(tables, config, camera, key, w, h, spp, stats=stats,
                                       order=order)
        assert torch.equal(got, want) and torch.equal(steps, want_steps)
        live = int(stats["counters"][RP.STATS.index("live_steps")])
        assert live == int(steps.long().sum()) and rec["ordered"] == 1
    with pytest.raises(ValueError, match="order"):
        RP.regen_pass(tables, config, camera, key, w, h, spp, order=first.long())
    with pytest.raises(ValueError, match="order"):
        RP.regen_pass(tables, config, camera, key, w, h, spp, order=first.cpu())


def test_renderer_orders_its_second_pass_on_card(card, monkeypatch):
    """A Renderer's first regen pass runs in row order and its second in
    the order learned from the first: ``ordered`` 0 then 1; a culled
    Renderer's passes (B1rc) all run in row order. The frame's
    long lanes are its bottom rows (the Cornell box seen from below the
    middle of its open front, eye (0, 3, 26), forward (0, 0.25, -1), 50
    degrees; 800x600, fixed depth 3, 16 spp: the top rows miss, 16
    steps, the floor's lanes up to ~60), so longest first cuts the share
    of the kernel after its list ran dry (``tail_ms / kernel_ms``). The
    frame has more lanes than the grid has slots, so slots take lanes
    from the ordered list after their first: the ordered pass's frame and
    ``lane_steps`` are a row-order launch's on its key, bit for bit."""
    w, h = 800, 600
    scene, _ = cornell.cornell_box(width=w, height=h, device="cuda")
    camera = Camera.look((0.0, 3.0, 26.0), (0.0, 0.25, -1.0), (0.0, 1.0, 0.0), width=w,
                         height=h, fov_x_deg=50.0, device="cuda")
    settings = RenderSettings(width=w, height=h, spp_per_pass=16, regen=True)
    r = Renderer(scene, camera, TraceConfig(mode="fixed", max_depth=3), settings,
                 device="cuda")
    frames, learned = [], []  # each pass's (key, frame); (its order, its lane_steps)

    def spy_planar(*args, **kw):
        frames.append((args[2], render_regen_planar(*args, **kw)))
        return frames[-1][1]

    learn = r.lanes.learn

    def spy_learn(shape, steps):
        learned.append((r.lanes.order, steps))
        learn(shape, steps)

    monkeypatch.setattr("montecarlopathtracer_tpu_torch.render.renderer.render_regen_planar",
                        spy_planar)
    r.lanes.learn = spy_learn
    recs = []
    for _ in range(2):
        with profiling.recording() as rec:
            r.render(1)
        recs.append(rec)
    assert [rec["ordered"] for rec in recs] == [0, 1]
    assert [rec["launches"] for rec in recs] == [{"B1r": 1}] * 2
    shares = [rec["tail_ms"] / rec["kernel_ms"] for rec in recs]
    assert shares[1] < shares[0], shares
    assert r.lanes.order is not None and r.lanes.order.shape == (w * h,)
    assert recs[1]["grid"] * RP.slots_per_block(r.config) < w * h
    (key, frame), (order, steps) = frames[1], learned[1]
    assert learned[0][0] is None and order is not None
    assert not torch.equal(order, torch.arange(w * h, dtype=torch.int32, device="cuda"))
    want, want_steps = RP.regen_pass(r.tables, r.config, camera, key, w, h, 16)
    assert torch.equal(steps, want_steps)
    assert torch.equal(frame, want.reshape(3, h, w) / 16.0)  # exact: a power of two
    # The culled instance (B1rc) keeps row order.
    gscene, gcam = glossy.glossy_steps(width=64, height=48, device="cuda")
    settings = RenderSettings(width=64, height=48, spp_per_pass=4, regen=True)
    g = Renderer(gscene, gcam, TraceConfig(mode="fixed", max_depth=3, chunk_cull=True),
                 settings, device="cuda")
    with profiling.recording() as rec:
        g.render(2)
    assert rec["launches"] == {"B1rc": 2} and rec["ordered"] == 0 and g.lanes.order is None


def test_regen_pass_spp1_equals_the_scan_on_card(card):
    scene, camera, _ = card
    config = TraceConfig(mode="rr", rr_depth=2, illum=1.0)
    tables = scene_tables(scene, config)
    got, _ = RP.regen_pass(tables, config, camera, make_key(18), 64, 48, 1)
    want = render_rows_planar(scene, camera, make_key(18), 64, 48, 0, 48, config, tables)
    assert torch.equal(got.reshape(3, 48, 64), want)


@pytest.mark.parametrize("which", ["cornell", "mcrt_band"])
def test_camera_formula_equals_torch_on_card(card, which):
    """The pass kernel's camera-ray formula in plain torch under the card's
    division rule (torch on CUDA divides by a Python number as a multiply
    by its f32 reciprocal) bit-equal to Camera.generate_rays_soa on the
    card; the kernel itself is held to the scan at 1 spp."""
    from montecarlopathtracer_tpu_torch.scene.camera import camera_for_mcrt

    w, h = 64, 48
    camera = card[1] if which == "cornell" else camera_for_mcrt(w, h, device="cuda")
    y0 = 0 if which == "cornell" else 8
    R = w * (h - y0)
    lanes = torch.arange(R, device="cuda")
    xs, ys = lanes % w, lanes // w + y0
    u = RNG.stream_uniforms(make_key(19), (1 << 30, (1 << 30) + 1), R, "cuda")
    o, d = camera.generate_rays_soa(xs, ys, u[0] * 2.0 - 1.0, u[1] * 2.0 - 1.0, w, h)
    o2, d2 = RP.camera_rays_ref(camera, xs, ys, u[0], u[1], w, h, scalar_div="card")
    assert torch.equal(o, o2) and torch.equal(d, d2)


def test_regen_pass_wrapper_refuses_on_card(card):
    scene, camera, _ = card
    config = TraceConfig(mode="rr", rr_depth=2, illum=1.0)
    tables = scene_tables(scene, config)
    with pytest.raises(ValueError, match="megakernel"):
        RP.regen_pass(tables, TraceConfig(intersector="traverse"), camera, make_key(0), 64, 48,
                      2)
    with pytest.raises(ValueError, match="spp"):
        RP.regen_pass(tables, config, camera, make_key(0), 64, 48, 0)
    with pytest.raises(ValueError, match="rows"):
        RP.regen_pass(tables, config, camera, make_key(0), 64, 48, 2, y0=40, n_rows=16)
    with pytest.raises(ValueError, match="camera"):
        RP.regen_pass(tables, config, camera.to("cpu"), make_key(0), 64, 48, 2)


def test_recording_sums_the_pass_kernels_counters_on_card(card, tmp_path):
    """Two B1r passes under recording() sum to their two stats; a
    Renderer pass under the profiler nests the key table's and the
    launch's spans in its pass span, and traced() reads its launch."""
    scene, camera, _ = card
    config = TraceConfig(mode="rr", rr_depth=2, illum=1.0)
    tables = scene_tables(scene, config)
    stats = [{}, {}]
    with profiling.recording() as rec:
        for i, st in enumerate(stats):
            RP.regen_pass(tables, config, camera, make_key(20 + i), 64, 48, 2, stats=st)
    cols = [st["counters"].cpu() for st in stats]
    for i, name in enumerate(RP.COUNTERS):
        assert rec[name] == sum(int(c[i]) for c in cols), name
    times = [RP.pass_times(c) for c in cols]
    assert rec["kernel_ms"] == pytest.approx(sum(end for _, end in times), abs=1e-9)
    assert rec["tail_ms"] == pytest.approx(
        sum(end - spent for spent, end in times if spent is not None), abs=1e-9)
    assert rec["launches"] == {"B1r": 2} and rec["grid"] == sum(st["grid"] for st in stats)
    assert rec["passes"] == 0 and 0 < rec["live_steps"] <= rec["slot_steps"]
    settings = RenderSettings(width=64, height=48, spp_per_pass=2, regen=True)
    r = Renderer(scene, camera, config, settings, device="cuda")
    r.render(1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        r.render(1)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = program_spans(tmp_path / "trace.json")
    (_, args, lo, hi), = [s for s in spans if s[0] == "pass"]
    assert args == {"pass": 1, "request": 2}
    for name in ("regen.keys", "regen.launch", "film.update"):
        assert any(s[0] == name and lo <= s[2] and s[3] <= hi for s in spans), name
    got = profiling.traced()
    assert got["passes"] == 1 and got["launches"] == {"B1r": 1} and got["kernel_ms"] > 0.0


def test_traverse_gradient_render_kernels_match_plain_path(bunny_card):
    scene, camera, _ = bunny_card
    config = TraceConfig(max_depth=3, intersector="traverse", ray_sort=True)
    loss_fn = G.make_loss_fn(scene, camera, torch.zeros(48, 64, 3, device="cuda"),
                             width=64, height=48, spp=1, config=config)
    params = G.split_params(scene, ("mat_kd", "mat_ka", "vertices"))
    before = profiling.launches()
    loss, got = G.value_and_grad(loss_fn, params, make_key(4))
    made = profiling.launches() - before
    names = ("B5", "B6", "B2", "B3")
    assert {k: made[k] for k in names} == dict.fromkeys(names, 4)
    with plain_kernels():
        loss_ref, want = G.value_and_grad(loss_fn, params, make_key(4))
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-5)
    rep = compare_param_grads(want, got, 1e-4)
    assert rep["ok"], rep


def test_traverse_wrappers_refuse_bad_inputs_on_card(bunny_card):
    _, camera, tables = bunny_card
    pos, dir_, tput, res, live = _waves(camera, tables.rows)[0]
    before = profiling.launches()
    with pytest.raises(TypeError, match="live"):
        TW.traverse_select(tables.rows, tables.clo, tables.chi, pos, dir_, live.float())
    with pytest.raises(ValueError, match="chunk boxes"):
        TW.traverse_select(tables.rows, tables.clo[:-1], tables.chi[:-1], pos, dir_, live)
    with pytest.raises(ValueError, match="on"):
        TW.traverse_select(tables.rows.cpu(), tables.clo, tables.chi, pos, dir_, live)
    with pytest.raises(ValueError, match="visits"):  # per ray now, not per tile
        TW.traverse_select(tables.rows, tables.clo, tables.chi, pos, dir_, live,
                           visits=torch.zeros(2, -(-pos.shape[1] // 128), dtype=torch.int32,
                                              device="cuda"))
    with pytest.raises(ValueError, match="walk tables"):
        TW.traverse_select(tables.rows, tables.clo, tables.chi, pos, dir_, live,
                           tables=tables.walk._replace(tri=tables.walk.tri[:-1]))
    idx = torch.zeros(pos.shape[1], dtype=torch.int64, device="cuda")
    u = torch.zeros(pos.shape[1], device="cuda")
    with pytest.raises(ValueError, match="int32"):
        F.rows_segment(tables.rows, idx, pos, dir_, tput, res, live, u, u, u,
                       torch.zeros(3, 1, device="cuda"))
    with pytest.raises(ValueError, match="flags"):
        F.rows_segment(tables.rows, idx.int(), pos, dir_, tput, res, live, u, u, u,
                       torch.zeros(3, 7, device="cuda"))
    assert profiling.launches() - before == {}


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
            before = profiling.launches()
            got = F.mega_segment(*args, mode=mode, tested=tested, **tables.cull_boxes)
            torch.cuda.synchronize()
            assert profiling.launches() - before == {"B1c": 1, **({"B1l": 1} if lane else {})}
            want = F.mega_segment_ref(*args, mode=mode)
            rep = compare_segment(want, got, live=live, rows=tables.rows, pos=pos, dir_=dir_)
            assert rep["ok"], rep
            t = tested.cpu()
            assert t.max() <= tables.clo.shape[0] and t.float().mean() < tables.clo.shape[0]


@pytest.mark.parametrize("case", ["B1 Cornell", "B1l Cornell", "B1 glossy", "B1c glossy",
                                  "B1c lane flags glossy"])
def test_whole_segment_winners_equal_split_kernel_on_card(card, glossy_card, case):
    """B1, B1l and B1c pick the winners of B4 (B4c for B1c, with the same
    chunks tested per block) bit for bit: the same accept chain on the same
    table, behind the segment kernel's division-free rejection."""
    cull = "B1c" in case
    if "Cornell" in case:
        camera, rows, boxes = card[1], card[2], {}
    else:
        camera, tables = glossy_card[1], glossy_card[2]
        rows = tables.rows if cull else F.pack_rows_full(glossy_card[0])
        boxes = tables.cull_boxes if cull else {}
    for pos, dir_, tput, res, live in _waves(camera, rows):
        R = pos.shape[1]
        key = make_key(13)
        u1, u2, urr = (stream_uniform(key, s, R, "cuda") for s in (0, 1, 3))
        lane = case.startswith("B1l") or "lane" in case
        flags = _lane_flags(R, seed=7) if lane else \
            torch.tensor([[0.0], [1.0], [0.0]], device="cuda")
        nb = -(-R // 128)
        tested = torch.full((nb,), -1, dtype=torch.int32, device="cuda") if cull else None
        got = F.mega_segment(rows, pos, dir_, tput, res, live, u1, u2, urr, flags, mode="rr",
                             tested=tested, **boxes)
        want_tested = torch.full((nb,), -2, dtype=torch.int32, device="cuda") if cull else None
        want = NS.nearest_shade_full(rows, pos, dir_, live, tested=want_tested, **boxes)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        if cull:
            assert torch.equal(tested, want_tested)


@pytest.mark.parametrize("T", [700, 1500], ids=["whole_table", "tile_ring"])
@pytest.mark.parametrize("case", HARD_SOUPS)
def test_whole_segment_winners_equal_split_kernel_on_hard_soups(card, case, T):
    """B1 and B1c pick B4's and B4c's winners bit for bit (and B1c tests
    B4c's chunks) on soups made to find a pair that the sphere rejection
    drops wrongly, through both the whole-table path (T <= 760) and the
    tile ring; B4 with the |d'_z| test and B7 pick the control's (the
    one-ray-per-thread loop without a rejection); and on the soup in
    Morton order with its chunk boxes and their slack, B4c and B1c pick
    B4's (ROADMAP C15) and the walk B5 picks B4's."""
    R = 16384
    verts, rows, pos, dir_ = hard_soup(case, T, R, seed=T, device="cuda")
    ones = torch.ones(3, R, device="cuda")
    live = torch.ones(R, dtype=torch.bool, device="cuda")
    u = torch.full((R,), 0.5, device="cuda")
    flags = torch.zeros(3, 1, device="cuda")
    perm = torch.arange(T, device="cuda")
    clo, chi = chunk_aabbs_padded(*verts, torch.ones(T, dtype=torch.bool, device="cuda"), perm,
                                  128)
    for boxes in ({}, dict(clo=clo, chi=chi, cslack=CU.chunk_slack(rows))):
        nb = -(-R // 128)
        tested = torch.full((nb,), -1, dtype=torch.int32, device="cuda") if boxes else None
        want_tested = torch.full((nb,), -2, dtype=torch.int32, device="cuda") if boxes else None
        got = F.mega_segment(rows, pos, dir_, ones, ones, live, u, u, u, flags, tested=tested,
                             **boxes)
        want = NS.nearest_shade_full(rows, pos, dir_, live, tested=want_tested, **boxes)
        torch.cuda.synchronize()
        hits = want[0] >= 0
        assert hits.float().mean() > 0.25, (case, T, float(hits.float().mean()))
        assert torch.equal(got[0], want[0]), int((got[0] != want[0]).sum())
        if boxes:
            assert torch.equal(tested, want_tested)
    geom = rows[:, :12].contiguous()
    control = NS.nearest_triangle_control(geom, pos, dir_)
    dz = NS.nearest_shade_full(rows, pos, dir_, live, dz_test=True)[0]
    assert torch.equal(dz, control), int((dz != control).sum())
    b7 = NS.nearest_triangle(geom, pos, dir_)
    assert torch.equal(b7, control), int((b7 != control).sum())
    valid = torch.ones(T, dtype=torch.bool, device="cuda")
    mperm = morton_order(*verts, valid)
    mrows = rows[mperm].contiguous()
    mclo, mchi = chunk_aabbs_padded(*verts, valid, mperm, 128)
    mboxes = dict(clo=mclo, chi=mchi, cslack=CU.chunk_slack(mrows))
    walk = TW.traverse_select(mrows, mclo, mchi, pos, dir_, live)
    split = NS.nearest_shade_full(mrows, pos, dir_, live)[0]
    b4c = NS.nearest_shade_full(mrows, pos, dir_, live, **mboxes)[0]
    b1c = F.mega_segment(mrows, pos, dir_, ones, ones, live, u, u, u, flags, **mboxes)[0]
    torch.cuda.synchronize()
    assert torch.equal(walk, split), int((walk != split).sum())
    assert torch.equal(b4c, split), int((b4c != split).sum())
    assert torch.equal(b1c, split), int((b1c != split).sum())
    if case == "slivers":  # winners on both sides of the kappa = 2^16 cut
        m = rows[want[0][hits].long(), :12].double().reshape(-1, 3, 4)[:, :, :3]
        kappa = m.flatten(1).norm(dim=1) * torch.linalg.inv(m).flatten(1).norm(dim=1)
        assert ((kappa >= 2.0 ** 15) & (kappa < 2.0 ** 16)).any() and (kappa >= 2.0 ** 16).any()


def _culled_vs_b4(rows, boxes, pos, dir_, live):
    """B4c and B1c against B4 on one Morton-ordered table: (B4c's outputs
    and B1c's idx bit-equal to B4's, B4c's tested counts equal to the
    emulation of its rule (``ops.cull.cull_visits``, each chunk's winners
    from B4))."""
    R = pos.shape[1]

    def b4_chunk(r, p, d):
        idx, tbg, _ = NS.nearest_shade_full(r, p, d, torch.ones(R, dtype=torch.bool,
                                                                 device="cuda"))
        return tbg[0], idx

    tested = torch.full((-(-R // 128),), -1, dtype=torch.int32, device="cuda")
    want = NS.nearest_shade_full(rows, pos, dir_, live)
    got = NS.nearest_shade_full(rows, pos, dir_, live, tested=tested, **boxes)
    ones = torch.ones(3, R, device="cuda")
    u = torch.full((R,), 0.5, device="cuda")
    b1c = F.mega_segment(rows, pos, dir_, ones, ones, live, u, u, u,
                         torch.zeros(3, 1, device="cuda"), **boxes)[0]
    visits = CU.cull_visits(rows, boxes["clo"], boxes["chi"], boxes["cslack"], pos, dir_, live,
                            winners=CU.chunk_winners(rows, pos, dir_, select=b4_chunk,
                                                     chunk=CU.LEAF))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(b1c, want[0])
    return same, bool(torch.equal(tested.long(), visits["tested"]))


def _entries_vs_b4(verts, pos, dir_, live, seed):
    """B10c and B11 on the soup padded to a multiple of 128 with all-zero
    rows (the JAX packings, Morton order, a seeded shading table) against
    B4 over the same rows (B11 with the |d'_z| test): bit-equal."""
    T = verts[0].shape[0]
    pad = -T % 128
    a, b, c = (torch.cat([x, torch.zeros(pad, 3, device="cuda")]) for x in verts)
    valid = torch.cat([torch.ones(T, dtype=torch.bool, device="cuda"),
                       torch.zeros(pad, dtype=torch.bool, device="cuda")])
    perm = morton_order(a, b, c, valid)
    m, m_a = triangle_transforms(a, b, c)
    g = torch.Generator(device="cuda").manual_seed(seed)
    tp = torch.rand(T + pad, 32, device="cuda", generator=g)
    wp = NV.pack_transforms(m[perm], m_a[perm], valid[perm])
    rows_p = NV._rows(NV._geometry(wp), tp)
    assert (rows_p[T:, :12] == 0).all()
    ws_c = NV.pack_transforms_stream(m[perm], m_a[perm], valid[perm], 128)
    clo, chi = chunk_aabbs_padded(a, b, c, valid, perm, 128)
    before = profiling.launches()
    b10c = NV.nearest_shade_streamed(ws_c, NV._geometry(wp).contiguous(), tp, pos, dir_, live,
                                     clo, chi, t_chunk=128, cull=True)
    b11 = NV.nearest_shade_culled(wp, tp, *chunk_aabbs(a, b, c, valid, perm, 128), pos, dir_,
                                  live)
    want = NS.nearest_shade_full(rows_p, pos, dir_, live)
    want_dz = NS.nearest_shade_full(rows_p, pos, dir_, live, dz_test=True)
    torch.cuda.synchronize()
    # Each entry builds its records with its unpacking: one B4r launch each.
    made = profiling.launches() - before
    assert (made["B10c"], made["B11"], made["B4r"]) == (1, 1, 2)
    return (all(torch.equal(x, y) for x, y in zip(b10c, want)),
            all(torch.equal(x, y) for x, y in zip(b11, want_dz)))


@pytest.mark.parametrize("T", [700, 1500])
@pytest.mark.parametrize("case", HARD_SOUPS)
def test_culled_kernels_equal_b4_on_morton_soups(card, case, T):
    """The culled loop (a vote per warp, nearest chunk first, the least
    (t, index) pair winning) under B4c, B1c, B10c and B11 picks B4's bits
    on every lane of the seeded hard soups in Morton order, some lanes
    dead; B4c's tested counts equal the emulation of its rule; the entries
    run on the soup padded with all-zero rows."""
    R = 16384
    verts, rows, pos, dir_ = hard_soup(case, T, R, seed=T, device="cuda")
    live = torch.ones(R, dtype=torch.bool, device="cuda")
    live[::7] = False
    valid = torch.ones(T, dtype=torch.bool, device="cuda")
    perm = morton_order(*verts, valid)
    mrows = rows[perm].contiguous()
    clo, chi = chunk_aabbs_padded(*verts, valid, perm, 128)
    boxes = dict(clo=clo, chi=chi, cslack=CU.chunk_slack(mrows), crec=CU.cull_records(mrows))
    same, tested = _culled_vs_b4(mrows, boxes, pos, dir_, live)
    assert same and tested, (same, tested)
    assert _entries_vs_b4(verts, pos, dir_, live, seed=T) == (True, True)


def test_culled_kernels_break_equal_t_ties_by_index_on_card(card):
    """On ``testing.tie_soup`` the warps meet each winner's exact copy (a
    larger index, in chunk 2, whose box they enter first) before the
    winner: B4c, B1c, B10c and B11 keep the smaller index, B4's."""
    verts, rows, clo, chi, pos, dir_ = tie_soup(device="cuda", R=4096, seed=5)
    live = torch.ones(pos.shape[1], dtype=torch.bool, device="cuda")
    boxes = dict(clo=clo, chi=chi, cslack=CU.chunk_slack(rows), crec=CU.cull_records(rows))
    tn, ok = CU.chunk_entry(clo, chi, pos.T, dir_.T, boxes["cslack"])
    assert ok[:, [0, 2]].all() and (tn[:, 2] < tn[:, 0]).all()
    same, tested = _culled_vs_b4(rows, boxes, pos, dir_, live)
    assert same and tested, (same, tested)
    idx = NS.nearest_shade_full(rows, pos, dir_, live, **boxes)[0]
    assert ((idx >= 0) & (idx < 64)).float().mean() > 0.9
    # The entries take the soup in Morton order, whose chunks are others.
    assert _entries_vs_b4(verts, pos, dir_, live, seed=5) == (True, True)


def test_culled_tested_equals_the_emulation_on_card(glossy_card):
    """B4c's and B1c's tested counts per group of 128 rays are the OR of
    its two warps' votes: those of ``ops.cull.cull_visits``' rule (d) on
    the glossy camera wavefront and its first bounce."""
    _, camera, tables = glossy_card
    for pos, dir_, _, _, live in _waves(camera, tables.rows):
        same, tested = _culled_vs_b4(tables.rows, tables.cull_boxes, pos, dir_, live)
        assert same and tested, (same, tested)


def test_culled_wrappers_refuse_bad_records_on_card(glossy_card):
    _, camera, tables = glossy_card
    pos, dir_, _, _, live = _waves(camera, tables.rows)[0]
    boxes = tables.cull_boxes
    before = profiling.launches()
    for bad in (boxes["crec"][:-1], boxes["crec"].cpu(), boxes["crec"][:, :12]):
        with pytest.raises(ValueError, match="records"):
            NS.nearest_shade_full(tables.rows, pos, dir_, live, **dict(boxes, crec=bad))
        with pytest.raises(ValueError, match="records"):
            F.mega_segment(tables.rows, pos, dir_, pos, pos, live, live.float(), live.float(),
                           live.float(), torch.zeros(3, 1, device="cuda"),
                           **dict(boxes, crec=bad))
    with pytest.raises(ValueError, match="records"):
        CU.cull_records(tables.rows[:, :12])
    assert profiling.launches() - before == {}
    # Records built by the wrapper when none are given: one B4r launch.
    got = NS.nearest_shade_full(tables.rows, pos, dir_, live, **dict(boxes, crec=None))
    torch.cuda.synchronize()
    assert profiling.launches() - before == {"B4r": 1, "B4c": 1}
    want = NS.nearest_shade_full(tables.rows, pos, dir_, live, **boxes)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cull_records_kernel_matches_plain_on_card(glossy_card):
    _, _, tables = glossy_card
    rows = tables.rows.detach()
    got = CU.cull_records(rows)
    want = CU.cull_records_ref(rows)
    assert torch.equal(got, tables.crec) and got.shape == CU.records_shape(rows.shape[0])
    assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got.isinf(), want.isinf())
    assert torch.equal(got[:rows.shape[0], 4:], rows[:, :12])
    fin = want.isfinite()
    assert ((got - want)[fin].abs() <= 1e-4 * (1.0 + want[fin].abs())).all()


@pytest.mark.parametrize("cull", [False, True], ids=["B4", "B4c"])
def test_nearest_shade_kernel_matches_plain_on_card(card, glossy_card, cull):
    cases = [(card[1], card[2], {}),
             (glossy_card[1], glossy_card[2].rows if cull else F.pack_rows_full(glossy_card[0]),
              glossy_card[2].cull_boxes if cull else {})]
    if cull:
        cases = cases[1:]
    for camera, rows, boxes in cases:
        for pos, dir_, _, _, live in _waves(camera, rows):
            before = profiling.launches()
            got = NS.nearest_shade_full(rows, pos, dir_, live, **boxes)
            torch.cuda.synchronize()
            assert profiling.launches() - before == {"B4c" if cull else "B4": 1}
            want = NS.nearest_shade_full_ref(rows, pos, dir_, live)
            rep = compare_shade(got, want, live=live, rows=rows, pos=pos, dir_=dir_)
            assert rep["ok"], rep


def test_nearest_triangle_kernel_matches_plain_on_card(card, glossy_card):
    for scene, camera in (card[:2], glossy_card[:2]):
        rows = F.pack_rows_full(scene)
        geom = rows[:, :12].contiguous()
        for pos, dir_, _, _, _ in _waves(camera, rows):
            before = profiling.launches()
            got = NS.nearest_triangle(geom, pos, dir_)
            torch.cuda.synchronize()
            assert profiling.launches() - before == {"B7": 1}
            want = NS.nearest_triangle_ref(geom, pos, dir_)
            rep = compare_winners(got, want, live=torch.ones_like(got, dtype=torch.bool),
                                  rows=rows, pos=pos, dir_=dir_)
            assert rep["ok"], rep


def _b7_waves(card, glossy_card, which):
    """(geom f32[T, 12], row table, [(pos, dir, live)]) of one wavefront
    set: the Cornell or glossy camera wavefront and its first bounce, or
    the twelve hard soups."""
    if which in ("cornell", "glossy"):
        scene, camera = (card if which == "cornell" else glossy_card)[:2]
        rows = F.pack_rows_full(scene)
        return [(rows, [(w[0], w[1], w[4]) for w in _waves(camera, rows)])]
    out = []
    for case in HARD_SOUPS:
        for T in (700, 1500):
            _, rows, pos, dir_ = hard_soup(case, T, 16384, seed=T, device="cuda")
            out.append((rows, [(pos, dir_, torch.ones(16384, dtype=torch.bool,
                                                      device="cuda"))]))
    return out


@pytest.mark.parametrize("which", ["cornell", "glossy", "hard_soups"])
def test_fused_index_equals_control_loop_on_card(card, glossy_card, which):
    """B7 (on the shared selection loop) and B4 with the |d'_z| test pick
    the winners of the control, the one-ray-per-thread loop without the
    sphere rejection, bit for bit; B7 counts its launches, the control
    none."""
    for rows, waves in _b7_waves(card, glossy_card, which):
        geom = rows[:, :12].contiguous()
        for pos, dir_, live in waves:
            before = profiling.launches()
            control = NS.nearest_triangle_control(geom, pos, dir_)
            b7 = NS.nearest_triangle(geom, pos, dir_)
            dz = NS.nearest_shade_full(rows, pos, dir_, live, dz_test=True)[0]
            torch.cuda.synchronize()
            assert profiling.launches() - before == {"B7": 1, "B4": 1}
            assert torch.equal(b7, control), int((b7 != control).sum())
            assert torch.equal(dz, torch.where(live, control, -1))
            assert (control >= 0).float().mean() > 0.1


@pytest.mark.parametrize("kw", [dict(whole_segment=False), dict(intersector="fused"),
                                dict(chunk_cull=True), dict(chunk_cull=True, ray_sort=True),
                                dict(whole_segment=False, chunk_cull=True)],
                         ids=["split", "fused", "cull", "cull_sort", "split_cull"])
def test_split_and_cull_renders_on_card_match_cpu_plain_path(glossy_card, kw):
    scene, camera, _ = glossy_card
    config = TraceConfig(max_depth=3, **kw)
    before = profiling.launches()
    got = render_sample_batch(scene, camera, make_key(2), 64, 48, config)
    made = profiling.launches() - before
    assert any(made[k] for k in ("B1c", "B4", "B4c", "B7"))
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
    before = profiling.launches()
    loss, got = G.value_and_grad(loss_fn, params, make_key(4))
    made = profiling.launches() - before
    split = intersector == "megakernel"
    assert (made["B4"] + made["B4c"], made["B7"], made["B3"]) == \
        (4 * split, 4 * (not split), 4 * split)
    with plain_kernels():
        loss_ref, want = G.value_and_grad(loss_fn, params, make_key(4))
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-5)
    rep = compare_param_grads(want, got, 1e-4)
    assert rep["ok"], rep


def test_split_wrappers_refuse_bad_inputs_on_card(glossy_card):
    _, camera, tables = glossy_card
    pos, dir_, _, _, live = _waves(camera, tables.rows)[0]
    before = profiling.launches()
    with pytest.raises(TypeError, match="live"):
        NS.nearest_shade_full(tables.rows, pos, dir_, live.float())
    with pytest.raises(ValueError, match="chunk boxes"):
        NS.nearest_shade_full(tables.rows, pos, dir_, live, tables.clo[:-1], tables.chi[:-1],
                              tables.cslack)
    with pytest.raises(ValueError, match="chunk boxes"):
        F.mega_segment(tables.rows, pos, dir_, pos, pos, live, live.float(), live.float(),
                       live.float(), torch.zeros(3, 1, device="cuda"), clo=tables.clo.cpu(),
                       chi=tables.chi, cslack=tables.cslack)
    with pytest.raises(ValueError, match="slack"):
        NS.nearest_shade_full(tables.rows, pos, dir_, live, tables.clo, tables.chi)
    with pytest.raises(ValueError, match=r"\[T, 12\]"):
        NS.nearest_triangle(tables.rows, pos, dir_)
    with pytest.raises(ValueError, match="contiguous"):
        NS.nearest_triangle(tables.rows[:, :12], pos, dir_)
    assert profiling.launches() - before == {}


@pytest.mark.parametrize("which", ["cornell", "glossy"], ids=["652+116", "1332+76"])
def test_padding_rows_change_no_winner_on_card(card, glossy_card, which):
    """All-zero geometry rows fail the sphere test (``sphere_select.cuh::
    triangle_sphere``), and the exact test can never accept them: B4, B4c,
    B1 and B7 on the Morton-ordered table padded to a multiple of 128 with
    such rows (652 + 116 = 768 rows: the tile ring since the table no
    longer fits whole, as the entries B8-B10 run it; 1,332 + 76: the ring)
    pick the unpadded table's winners bit for bit, and B7 and B4 with the
    |d'_z| test the control loop's; with one zero row after every fourth
    row (no culling), the same winners at their new indices."""
    scene, camera = (card if which == "cornell" else glossy_card)[:2]
    tables = scene_tables(scene, TraceConfig(chunk_cull=True))
    rows, boxes = tables.rows, tables.cull_boxes
    T = rows.shape[0]
    pad = -T % 128
    padded = torch.cat([rows, torch.zeros(pad, 48, device="cuda")]).contiguous()
    where = torch.zeros(T + T // 4, dtype=torch.bool, device="cuda")
    where[5 * torch.arange(T // 4, device="cuda") + 4] = True
    spread = torch.zeros(T + T // 4, 48, device="cuda")
    spread[~where] = rows
    new = torch.nonzero(~where)[:, 0].int()
    boxes_p = dict(boxes, cslack=CU.chunk_slack(padded), crec=CU.cull_records(padded))
    assert torch.equal(boxes_p["cslack"], boxes["cslack"])
    for pos, dir_, tput, res, live in _waves(camera, rows):
        R = pos.shape[1]
        want = NS.nearest_shade_full(rows, pos, dir_, live)
        got = NS.nearest_shade_full(padded, pos, dir_, live)
        b4c = NS.nearest_shade_full(padded, pos, dir_, live, **boxes_p)
        u = torch.full((R,), 0.5, device="cuda")
        b1 = F.mega_segment(padded, pos, dir_, tput, res, live, u, u, u,
                            torch.zeros(3, 1, device="cuda"))[0]
        control = NS.nearest_triangle_control(rows[:, :12].contiguous(), pos, dir_)
        geom_p = padded[:, :12].contiguous()
        b7 = NS.nearest_triangle(geom_p, pos, dir_)
        dz = NS.nearest_shade_full(padded, pos, dir_, live, dz_test=True)[0]
        torch.cuda.synchronize()
        assert (want[0] >= 0).float().mean() > 0.1  # the glossy stage is open: many misses
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(b4c[0], want[0]) and torch.equal(b1, want[0])
        assert torch.equal(NS.nearest_triangle_control(geom_p, pos, dir_), control)
        assert torch.equal(b7, control) and torch.equal(dz, torch.where(live, control, -1))
        hit = want[0] >= 0
        moved = torch.where(hit, new[want[0].clamp_min(0).long()], -1)
        spread_idx = NS.nearest_shade_full(spread, pos, dir_, live)[0]
        spread_b7 = NS.nearest_triangle(spread[:, :12].contiguous(), pos, dir_)
        torch.cuda.synchronize()
        assert torch.equal(spread_idx, moved)
        assert torch.equal(spread_b7, torch.where(control >= 0,
                                                  new[control.clamp_min(0).long()], -1))


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
    entry = "B11" if name == "B11w" else name
    for pos, dir_, _, _, live in _waves(camera, tables.rows):
        call, rows = _variant_calls(scene, tables.perm, pos, dir_, live)[name]
        before = profiling.launches()
        got = call()
        torch.cuda.synchronize()
        made = profiling.launches() - before
        cull = name in ("B10c", "B11", "B11w")
        assert [k for k in ("B8", "B9", "B10", "B10c", "B11") if made[k]] == [entry]
        assert (made[entry], made["B4"], made["B4c"]) == (1, 1 - cull, cull)
        with plain_kernels():
            want = call()
        every = name in ("B8", "B9")  # these entries have no live mask
        lanes = torch.ones_like(live) if every else live
        rep = compare_shade(got, want, live=lanes, rows=rows, pos=pos, dir_=dir_)
        assert rep["ok"], rep


@pytest.mark.parametrize("R", [5000, 1037], ids=["R5000", "R1037"])
@pytest.mark.parametrize("variant", SM.VARIANTS)
def test_selection_micro_matches_plain_on_card(card, variant, R):
    """B12 on the tensor cores against the plain version by
    ``testing.compare_micro``'s rounding rule, at R = 5000 and 1037 rays
    (neither a multiple of the kernel's 256-ray tile), T = 768 in chunks
    of 256."""
    g = torch.Generator(device="cuda").manual_seed(3)
    ws = torch.randn(SM.K, 6 * 768, device="cuda", generator=g).to(torch.bfloat16)
    rays = torch.randn(SM.K, R, device="cuda", generator=g).to(torch.bfloat16)
    before = profiling.launches()
    got = SM.selection_micro(ws, rays, 256, variant)
    torch.cuda.synchronize()
    assert profiling.launches() - before == {f"B12 {variant}": 1}
    rep = compare_micro(ws, rays, 256, variant, got, SM.selection_micro_ref(ws, rays, 256,
                                                                            variant))
    assert rep["ok"], rep
    with pytest.raises(ValueError, match="contiguous"):
        SM.selection_micro(ws, rays[:, ::2], 256, variant)
    with pytest.raises(ValueError, match="multiple of 8"):
        SM.selection_micro(ws, rays, 12, variant)
    assert profiling.launches() - before == {f"B12 {variant}": 1}


def test_selection_epilogues_match_plain_on_card(card):
    g = torch.Generator(device="cuda").manual_seed(4)
    p_all = torch.randn(6 * 768, 3000, device="cuda", generator=g)
    before = profiling.launches()
    got = SM.epilogue_only(p_all, 256)
    torch.cuda.synchronize()
    assert profiling.launches() - before == {"B13": 1}
    assert torch.equal(got, SM.epilogue_only_ref(p_all, 256))
    p_blk = torch.randn(6 * 256, 512, device="cuda", generator=g)
    before = profiling.launches()
    got = SM.epilogue_shared(p_blk, 768, 3000)
    torch.cuda.synchronize()
    assert profiling.launches() - before == {"B14": 1}
    assert torch.equal(got, SM.epilogue_shared_ref(p_blk, 768, 3000))


@pytest.mark.parametrize("R,Rt,tc,T", [(3000, 512, 256, 768), (3000, 128, 256, 256),
                                       (1037, 128, 256, 768), (5000, 512, 256, 256),
                                       (1000, 100, 40, 120)])
def test_epilogue_shared_kernel_is_bit_equal_to_plain(card, R, Rt, tc, T):
    """B14's shared-memory kernel equals ``epilogue_shared_ref`` bit for
    bit: R not a multiple of Rt, Rt of 128 and 512 (and 100: a partial
    group of columns), T one and three chunks (tc = 40: a stage of 16
    triangles cut short); then with w (rows 5 tc ..) holding zeros,
    subnormals, huge and non-finite values in some columns, which take
    the kernel's exact reciprocal."""
    g = torch.Generator(device="cuda").manual_seed(R + Rt + T)
    p_blk = torch.randn(6 * tc, Rt, device="cuda", generator=g)
    special = torch.tensor([0.0, -0.0, 1e-40, -3e-39, 2.0 ** -126, 2.0 ** 126, 3e38,
                            float("inf"), -float("inf"), float("nan")], device="cuda")
    odd = p_blk.clone()
    pick = torch.randint(0, special.numel(), (tc, -(-Rt // 3)), device="cuda", generator=g)
    odd[5 * tc:, ::3] = special[pick]
    before = profiling.launches()
    for blk in (p_blk, odd):
        want = SM.epilogue_shared_ref(blk, T, R)
        assert (want >= 0).float().mean() > 0.3
        got = SM.epilogue_shared(blk, T, R)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert profiling.launches() - before == {"B14": 2}
    with pytest.raises(ValueError, match="multiple of 4"):
        SM.epilogue_shared(torch.randn(6 * tc, 130, device="cuda"), T, R)
    with pytest.raises(ValueError, match="do not make chunks"):
        SM.epilogue_shared(p_blk, T + 1, R)


def test_kdtree_render_on_card_matches_cpu(card):
    scene, camera, _ = card
    config = TraceConfig(max_depth=3, intersector="kdtree")
    got = render_sample_batch(scene, camera, make_key(2), 64, 48, config)
    want = render_sample_batch(scene.to("cpu"), camera.to("cpu"), make_key(2), 64, 48, config)
    rep = compare_images(got, want)
    assert rep["ok"], rep


SHARDED_KERNELS = ("segment_fused", "segment_backward", "scatter_rows", "rng")


def test_sharded_paths_at_world_size_one_under_nccl_on_card(card, tmp_path):
    """A real NCCL process group of one rank in this process: the sharded
    pass, train step and regen pass bit-equal to their single-process
    emulations, through the kernels."""
    import torch.distributed as dist

    from montecarlopathtracer_tpu_torch import testing as T
    from montecarlopathtracer_tpu_torch.parallel import distributed, make_mesh
    from montecarlopathtracer_tpu_torch.parallel import sharded as SH

    scene, camera, _ = card
    cfg, rcfg = TraceConfig(max_depth=3), TraceConfig(mode="rr", rr_depth=2, illum=1.0)
    kw = dict(width=64, height=48, spp=2)
    distributed.ensure_initialized(init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        assert (mesh.backend, mesh.device.type) == ("nccl", "cuda")
        before = profiling.launches()
        with torch.no_grad():
            got = SH.sharded_sample_pass(mesh, config=cfg, **kw)(scene, camera, make_key(4))
            assert (profiling.launches() - before)["B1"] == 2 * cfg.num_segments
            want = T.emulate_sample_pass(scene, camera, make_key(4), (1, 1), config=cfg, **kw)
        assert torch.equal(got, want)
        got = SH.sharded_regen_pass(mesh, config=rcfg, **kw)(scene, camera, make_key(5))
        assert torch.equal(got, T.emulate_regen_pass(scene, camera, make_key(5), (1, 1),
                                                     config=rcfg, **kw))
        params = G.split_params(scene, ("mat_kd", "mat_ka"))
        target = torch.zeros(48, 64, 3, device="cuda")
        new, loss = SH.make_train_step(mesh, scene, camera, config=cfg, **kw)(
            params, target, make_key(6))
        wnew, wloss = T.emulate_train_step(scene, camera, params, target, make_key(6), (1, 1),
                                           config=cfg, lr=0.5, **kw)
        assert torch.equal(loss, wloss) and all(torch.equal(new[k], wnew[k]) for k in new)
    finally:
        dist.destroy_process_group()


def test_graft_entry_renders_on_card(card):
    """``graft_entry.entry()``: one forward pass of the flagship scene at
    128×128, fixed depth 7, through B1 on the card."""
    from montecarlopathtracer_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    before = profiling.launches()
    with torch.no_grad():
        img = fn(*args)
    torch.cuda.synchronize()
    assert tuple(img.shape) == (128, 128, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0 and (profiling.launches() - before)["B1"] == 8


def test_two_gloo_ranks_share_the_card(card):
    """Two ranks spawned on cuda:0 with gloo (NCCL refuses two ranks on one
    device): frames gathered from meshes (2,1) and (1,2) and a train step
    at (2,1), bit-equal to the emulation of the two ranks."""
    import numpy as np

    from montecarlopathtracer_tpu_torch import testing as T
    from montecarlopathtracer_tpu_torch.parallel.launch import run_ranks

    scene, camera, _ = card
    target = np.zeros((48, 64, 3), np.float32)
    base = dict(width=64, height=48, spp=2, config=dict(max_depth=3), seed=7,
                scene=dict(with_mirror_sphere=True, with_glass_sphere=True))
    cases = [dict(base, kind="sample", mesh=(2, 1)), dict(base, kind="sample", mesh=(1, 2)),
             dict(base, kind="train", mesh=(2, 1), fields=("mat_kd", "mat_ka"), kd_scale=0.5,
                  target=target, lr=0.5)]
    cuda_build.build_all(SHARDED_KERNELS)  # here, so that no two ranks run nvcc
    ranks = run_ranks(T.sharded_cases, 2, (cases, "cuda"), backend="gloo", timeout=300)
    kw = dict(width=64, height=48, spp=2, config=TraceConfig(max_depth=3))
    for i, mesh in enumerate([(2, 1), (1, 2)]):
        with torch.no_grad():
            want = T.emulate_sample_pass(scene, camera, make_key(7), mesh, **kw).cpu().numpy()
        assert all(np.array_equal(r[i], want) for r in ranks)
    params = G.split_params(scene, ("mat_kd", "mat_ka"))
    params["mat_kd"] = params["mat_kd"] * 0.5
    new, loss = T.emulate_train_step(scene, camera, params, torch.as_tensor(target).cuda(),
                                     make_key(7), (2, 1), lr=0.5, **kw)
    for r in ranks:
        assert np.array_equal(r[2]["loss"], loss.cpu().numpy())
        assert all(np.array_equal(r[2]["params"][k], new[k].cpu().numpy()) for k in new)


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2), (1, 4)], ids=["4x1", "2x2", "1x4"])
def test_sharded_paths_on_four_cards_under_nccl(card, mesh):
    """One rank per card under NCCL, the default, where the host has four
    cards: the gathered frame, regen frame and a train step against the
    emulation of the four ranks, to 1e-6 (an all-reduce of four ranks may
    sum in another order than the emulation's)."""
    import numpy as np

    from montecarlopathtracer_tpu_torch import testing as T
    from montecarlopathtracer_tpu_torch.parallel.launch import run_ranks

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    scene, camera, _ = card
    target = np.zeros((48, 64, 3), np.float32)
    base = dict(width=64, height=48, spp=4, config=dict(max_depth=3), seed=8, mesh=mesh,
                scene=dict(with_mirror_sphere=True, with_glass_sphere=True))
    rcfg = dict(mode="rr", rr_depth=2, illum=1.0)
    cases = [dict(base, kind="sample"), dict(base, kind="regen", config=rcfg),
             dict(base, kind="train", fields=("mat_kd", "mat_ka"), kd_scale=0.5,
                  target=target, lr=0.5)]
    cuda_build.build_all(SHARDED_KERNELS)  # here, so that no two ranks run nvcc
    ranks = run_ranks(T.sharded_cases, 4, (cases, "cuda"), timeout=300)
    kw = dict(width=64, height=48, spp=4)
    with torch.no_grad():
        frames = [T.emulate_sample_pass(scene, camera, make_key(8), mesh,
                                        config=TraceConfig(max_depth=3), **kw),
                  T.emulate_regen_pass(scene, camera, make_key(8), mesh,
                                       config=TraceConfig(**rcfg), **kw)]
    for i, want in enumerate(frames):
        for r in ranks:
            np.testing.assert_allclose(r[i], want.cpu().numpy(), rtol=0, atol=1e-6)
    params = G.split_params(scene, ("mat_kd", "mat_ka"))
    params["mat_kd"] = params["mat_kd"] * 0.5
    new, loss = T.emulate_train_step(scene, camera, params, torch.as_tensor(target).cuda(),
                                     make_key(8), mesh, lr=0.5, config=TraceConfig(max_depth=3),
                                     **kw)
    for r in ranks:
        np.testing.assert_allclose(r[2]["loss"], loss.cpu().numpy(), rtol=1e-6)
        rep = compare_param_grads({k: v.cpu().numpy() for k, v in new.items()},
                                  r[2]["params"], 1e-6)
        assert rep["ok"], rep
