"""The port's decorrelated gradient step (``diff/grad.py::make_loss_fn``'s
``seed_grad="own"``, Mitsuba's ``seed_grad``) on the CPU, at 32x24 and
2 + 2 spp a step on the benchmark's published Cornell box
(``perfbench/``'s ``adam_seed_grad`` cell cut to that size), with start
rows and targets drawn from each seed: the primal's loss, the red
wall's decorrelated Kd gradient and the Adam update against the plain
reference (``perfbench/reference/inverse_seed_grad.py``), three steps of
a job against the reference's own, the adjoint under the primal's key
(``perfbench/control_seed_grad.py``'s ``one_key``) against the default
step bit for bit, the default step
against the loss as it was written before the option, and the step's
spans. On the card: the graphed loss equal to the eager one, and one
whole 800x600 step enqueued with no host sync, its replay's launches
the decorrelated step's (B1 16 x spp, B1p 8 x spp, B2, B3 and B3s 8 x
spp, RNG 18 x spp, RNGp 9 x spp).

Tolerances (``tests/test_torch_inverse.py``'s, for the same reasons):

- loss and gradient, relative (the gradient's L1 over the row): 2e-6.
  The port's CPU path is plain f32 torch like the reference; the port
  sums the image and the loss in f32, the reference in f64.
- the row, its update and the moments: 2e-6 relative, as the gradient
  they follow from; Adam is in f32 on the port's side, f64 on the
  reference's.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from montecarlopathtracer_tpu_torch.diff import grad as G
from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key
from montecarlopathtracer_tpu_torch.testing import cap_torch_threads, program_spans
from montecarlopathtracer_tpu_torch.utils import profiling
from perfbench import control_seed_grad as C
from perfbench import harness
from perfbench.drivers import inverse as D
from perfbench.drivers import progressive as P
from perfbench.reference import inverse_seed_grad as RS

cap_torch_threads()

CELL = "cornell_box_inverse_seed_grad.adam_seed_grad"
W, H, SPP = 32, 24, 2
TOL = 2e-6
SEEDS = [(1, 0), (2**31 + 977, 1), (123456789012, 5)]


def _context(seed, device="cpu", **size):
    over = {"width": W, "height": H, "spp_per_pass": SPP} if not size else size
    return harness.load_context(CELL, seed, 0.0, False, device, over)


def _problem(ctx, seed_grad="own", target=None):
    """The port's scene, camera, loss (its gradient's samples by
    ``seed_grad``) and Adam step of the cell at the context's size, from
    a start row drawn from the seed, against ``target`` (drawn from the
    seed when None)."""
    scene, camera = P.program_scene(ctx)
    scene, camera = scene.to(ctx.device), camera.to(ctx.device)
    if target is None:
        target = torch.as_tensor(ctx.rng(7).uniform(0.0, 0.5, (ctx.height, ctx.width, 3))
                                 .astype(np.float32), device=ctx.device)
    loss_fn = G.make_loss_fn(scene, camera, target, width=ctx.width, height=ctx.height,
                             spp=int(ctx.traffic["spp_per_pass"]), config=P.trace_config(ctx),
                             seed_grad=seed_grad)
    kd = scene.mat_kd.clone()
    kd[D.material(ctx)] = torch.as_tensor(ctx.rng(8).uniform(0.05, 0.95, 3), dtype=torch.float32)
    step = G.make_adam_step(loss_fn, rows=[D.material(ctx)], **D.adam_options(ctx))
    return loss_fn, step, {"mat_kd": kd}, target


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).sum() / np.abs(want).sum()


@pytest.mark.parametrize("seed,g", SEEDS)
def test_loss_gradient_and_update_match_the_reference(seed, g):
    ctx = _context(seed)
    _, step, params, target = _problem(ctx)
    row = D.material(ctx)
    kd = params["mat_kd"][row].double().numpy()
    new, loss, state = step(params, fold_in(make_key(ctx.seed32), g))
    scene, cam, est = D.reference_scene(ctx)
    want_loss, want_grad = RS.loss_and_grad(scene, cam, est, D.step_key(ctx, g), SPP, target,
                                            row, kd)
    want_kd, want_m, want_v = RS.adam(kd, np.zeros(3), np.zeros(3), 1, want_grad,
                                      **D.adam_options(ctx))
    assert abs(float(loss) - want_loss) <= TOL * want_loss
    got_grad = state.m["mat_kd"][0].double().numpy() / (1.0 - D.adam_options(ctx)["betas"][0])
    assert _rel(got_grad, want_grad) <= TOL
    assert _rel(new["mat_kd"][row].double().numpy() - kd, want_kd - kd) <= TOL
    assert _rel(state.v["mat_kd"][0], want_v) <= TOL
    # The red wall's gradient is not 0, and the adjoint's samples are not the primal's.
    one_key = RS.loss_and_grad(scene, cam, est, D.step_key(ctx, g), SPP, target, row, kd,
                               grad_key=D.step_key(ctx, g))
    assert np.abs(want_grad).min() > 0.0
    assert one_key[0] == want_loss and not np.allclose(one_key[1], want_grad)


def test_the_references_pixel_blocks_sum_to_the_whole_frame():
    ctx = _context(3)
    _, _, params, target = _problem(ctx)
    scene, cam, est = D.reference_scene(ctx)
    args = (scene, cam, est, D.step_key(ctx, 4), SPP, target, D.material(ctx),
            params["mat_kd"][D.material(ctx)].double().numpy())
    whole, blocks = RS.loss_and_grad(*args), RS.loss_and_grad(*args, block=W * H // 3 + 1)
    # The loss sums in f64; the gradient's backward reduces a block's
    # lanes in the tracer's f32, in an order the block's size sets.
    assert blocks[0] == pytest.approx(whole[0], rel=1e-12)
    assert _rel(blocks[1], whole[1]) <= TOL


def test_three_steps_of_a_job_match_the_reference_step_by_step():
    ctx = _context(2**31 + 977)
    _, step, params, target = _problem(ctx)
    row, opts = D.material(ctx), D.adam_options(ctx)
    scene, cam, est = D.reference_scene(ctx)
    kd, m, v = params["mat_kd"][row].double().numpy(), np.zeros(3), np.zeros(3)
    start, state = kd, None
    for g in range(3):
        params, loss, state = step(params, fold_in(make_key(ctx.seed32), g), state)
        want_loss, grad = RS.loss_and_grad(scene, cam, est, D.step_key(ctx, g), SPP, target,
                                           row, kd)
        kd, m, v = RS.adam(kd, m, v, g + 1, grad, **opts)
        assert abs(float(loss) - want_loss) <= TOL * want_loss
        assert _rel(params["mat_kd"][row], kd) <= TOL
        assert _rel(state.m["mat_kd"][0], m) <= TOL and _rel(state.v["mat_kd"][0], v) <= TOL
    assert state.t == 3 and not np.allclose(kd, start)


@pytest.mark.parametrize("seed,g", SEEDS[:2])
def test_the_adjoint_under_the_primals_key_is_the_default_step_bit_for_bit(seed, g):
    ctx = _context(seed)
    shared, _, params, target = _problem(ctx, "shared")
    own, _, _, _ = _problem(ctx, "own", target)
    key = fold_in(make_key(ctx.seed32), g)
    want_loss, want = G.value_and_grad(shared, params, key)
    with C._one_key():
        got_loss, got = G.value_and_grad(own, params, key)
    assert G.fold_in is fold_in  # taken out again
    assert torch.equal(got_loss, want_loss) and torch.equal(got["mat_kd"], want["mat_kd"])
    own_loss, own_grad = G.value_and_grad(own, params, key)
    assert torch.equal(own_loss, want_loss)  # the primal's samples are the default's
    assert not torch.equal(own_grad["mat_kd"], want["mat_kd"])


def test_the_default_loss_is_the_loss_as_written_before_the_option(monkeypatch):
    ctx = _context(5)
    loss_fn, _, params, target = _problem(ctx, "shared")
    scene, camera = P.program_scene(ctx)
    key = fold_in(make_key(ctx.seed32), 3)

    def before(p, k):
        img = G.render_image(p, scene, camera, k, width=W, height=H, spp=SPP,
                             config=P.trace_config(ctx))
        return torch.mean((img - target) ** 2)

    want_loss, want = G.value_and_grad(before, params, key)
    renders = []
    whole = G.render_image
    monkeypatch.setattr(G, "render_image", lambda *a, **kw: renders.append(a[3]) or whole(*a, **kw))
    with profiling.recording() as rec, profile(activities=[ProfilerActivity.CPU]):
        got_loss, got = G.value_and_grad(loss_fn, params, key)
    assert torch.equal(got_loss, want_loss) and torch.equal(got["mat_kd"], want["mat_kd"])
    assert renders == [key] and "grad.primal" not in rec["spans"]


def test_the_decorrelated_loss_renders_twice_under_its_keys(monkeypatch):
    ctx = _context(6)
    loss_fn, _, params, _ = _problem(ctx)
    key = fold_in(make_key(ctx.seed32), 2)
    seen = []
    whole = G.render_image

    def render(*a, **kw):
        seen.append((a[3], torch.is_grad_enabled(), profiling.in_primal(), kw["spp"]))
        return whole(*a, **kw)

    monkeypatch.setattr(G, "render_image", render)
    G.value_and_grad(loss_fn, params, key)
    assert seen == [(key, False, True, SPP), (fold_in(key, G.GRAD_KEY), True, False, SPP)]
    assert G.GRAD_KEY == RS.GRAD_KEY and not profiling.in_primal()
    with pytest.raises(ValueError, match="seed_grad"):
        _problem(ctx, "mitsuba")


def test_a_step_records_the_primal_span_inside_its_forward(tmp_path):
    ctx = _context(5, width=16, height=12, spp_per_pass=1)
    _, step, params, _ = _problem(ctx)
    with profiling.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state = None
            for g in range(2):
                params, _, state = step(params, fold_in(make_key(ctx.seed32), g), state)
    assert rec["steps"] == 2 and rec["launches"] == {}  # the CPU path launches no kernel
    assert {k: rec["spans"][k][0] for k in rec["spans"]} == {
        "grad.step": 2, "grad.forward": 2, "grad.primal": 2, "grad.backward": 2,
        "grad.update": 2}
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = program_spans(tmp_path / "trace.json")
    forward = [s for s in spans if s[0] == "grad.forward"]
    primal = [s for s in spans if s[0] == "grad.primal"]
    assert len(primal) == 2
    assert all(a[2] <= b[2] and b[3] <= a[3] for a, b in zip(forward, primal))


def test_a_primal_block_marks_its_launches_until_it_closes():
    assert not profiling.in_primal()
    with pytest.raises(RuntimeError):
        with profiling.primal():
            with profiling.primal():
                assert profiling.in_primal()
            assert profiling.in_primal()
            raise RuntimeError
    assert not profiling.in_primal()
    assert {"B1p", "RNGp"} <= set(profiling.KERNELS)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _launches(spp):
    """A decorrelated step's launches: two renders' B1 and draws, the
    primal's counted again under B1p and RNGp, the adjoint's backward."""
    seg = 8 * spp
    return {"B1": 2 * seg, "B1p": seg, "B2": seg, "B3": seg, "B3s": seg,
            "RNG": 2 * (seg + spp), "RNGp": seg + spp}


@pytest.mark.cuda
def test_the_graphed_loss_replays_the_eager_one_on_the_card(card):
    ctx = _context(7, "cuda")
    loss_fn, _, params, _ = _problem(ctx)
    key = fold_in(make_key(3_900_000_001), 17)
    graphed, launches = G.graphed_loss(loss_fn, params, key)
    assert launches == _launches(SPP)  # 32 rows: every B3 call takes the small path
    for g in range(3):
        k = fold_in(key, g)
        want_loss, want = G.value_and_grad(loss_fn, params, k)
        got_loss, got = G.value_and_grad(graphed, params, k)
        assert torch.equal(got_loss, want_loss), g
        torch.testing.assert_close(got["mat_kd"], want["mat_kd"], rtol=1e-6, atol=0)
        params = {"mat_kd": params["mat_kd"] * 0.97}  # the next replay copies new inputs


@pytest.mark.cuda
def test_a_whole_step_on_the_card_waits_for_nothing(card):
    ctx = harness.load_context(CELL, 11, 0.0, False, "cuda")
    target = torch.zeros(ctx.height, ctx.width, 3, device="cuda")
    _, step, params, _ = _problem(ctx, target=target)
    params, _, state = step(params, make_key(1))  # loads the kernels, captures the graphs
    torch.cuda.synchronize()
    with profiling.recording() as rec:
        torch.cuda.set_sync_debug_mode("error")
        try:
            params, loss, state = step(params, make_key(2), state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert rec["steps"] == 1
    assert rec["launches"] == _launches(int(ctx.traffic["spp_per_pass"]))
    assert torch.isfinite(loss).item() and state.t == 2
