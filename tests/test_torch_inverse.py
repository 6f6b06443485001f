"""The port's inverse-rendering step on the CPU, at 32x24 and 2 spp a step
on the benchmark's published Cornell box (``perfbench/``'s inverse cell
cut to that size): its loss and the red wall's Kd gradient against the
plain reference (``perfbench/reference/inverse.py``), the projected Adam
step against ``torch.optim.Adam`` followed by ``clamp_``, three steps of
a job against the reference's own, the step's spans and counters, and a
device key's draws against its host key's. On the card: the keyed draws
bit-equal to the host-folded ones, the graphed loss (the Adam step's on
a card) equal to the eager one, and one whole 800x600 step enqueued
with no host sync, counting the launches its replay holds.

Tolerances:

- loss and gradient, relative (the gradient's L1 over the row): 2e-6.
  The port's CPU path is plain f32 torch like the reference; the port
  sums the image and the loss in f32, the reference in f64. Measured
  at most 1.7e-7 over four seeds and two steps.
- three steps of a job: the row and the moments to 2e-6 relative, as
  the gradient they follow from (measured 1e-7); Adam is in f32 on the
  port's side, f64 on the reference's.
- Adam against ``torch.optim.Adam``: 1e-6 relative (the same f32
  arithmetic in another order; measured bit-equal or one ulp).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from montecarlopathtracer_tpu_torch.diff import grad as G
from montecarlopathtracer_tpu_torch.ops import rng
from montecarlopathtracer_tpu_torch.ops.rng import DeviceKey, fold_in, make_key
from montecarlopathtracer_tpu_torch.testing import cap_torch_threads, program_spans
from montecarlopathtracer_tpu_torch.utils import profiling
from perfbench import harness
from perfbench.drivers import inverse as D
from perfbench.drivers import progressive as P
from perfbench.reference import inverse as RI

cap_torch_threads()

CELL = "cornell_box_inverse.adam_red_wall"
W, H, SPP = 32, 24, 2
TOL = 2e-6


def _context(seed, device="cpu", **size):
    over = {"width": W, "height": H, "spp_per_pass": SPP} if not size else size
    return harness.load_context(CELL, seed, 0.0, False, device, over)


def _problem(ctx, target=None):
    """The port's scene, camera, loss and Adam step of the cell at the
    context's size, against ``target`` (random, from the seed, when
    None)."""
    scene, camera = P.program_scene(ctx)
    scene, camera = scene.to(ctx.device), camera.to(ctx.device)
    if target is None:
        target = torch.as_tensor(ctx.rng(7).uniform(0.0, 0.5, (ctx.height, ctx.width, 3))
                                 .astype(np.float32), device=ctx.device)
    loss_fn = G.make_loss_fn(scene, camera, target, width=ctx.width, height=ctx.height,
                             spp=int(ctx.traffic["spp_per_pass"]), config=P.trace_config(ctx))
    kd = scene.mat_kd.clone()
    kd[D.material(ctx)] = torch.tensor(ctx.config["start"])
    step = G.make_adam_step(loss_fn, rows=[D.material(ctx)], **D.adam_options(ctx))
    return loss_fn, step, {"mat_kd": kd}, target


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).sum() / np.abs(want).sum()


@pytest.mark.parametrize("seed,g", [(1, 0), (2**31 + 977, 1), (123456789012, 5)])
def test_loss_and_red_row_gradient_match_the_reference(seed, g):
    ctx = _context(seed)
    loss_fn, _, params, target = _problem(ctx)
    key = fold_in(make_key(ctx.seed32), g)
    assert key == tuple(int(x) for x in D.step_key(ctx, g))
    loss, grads = G.value_and_grad(loss_fn, params, key)
    scene, cam, est = D.reference_scene(ctx)
    want_loss, want_grad = RI.loss_and_grad(scene, cam, est, D.step_key(ctx, g), SPP, target,
                                            D.material(ctx), ctx.config["start"])
    assert abs(float(loss) - want_loss) <= TOL * want_loss
    assert _rel(grads["mat_kd"][D.material(ctx)], want_grad) <= TOL
    # Only the materials the frame sees take a gradient; the red wall's is not 0.
    assert np.abs(want_grad).min() > 0.0


def _quadratic(weights, centre):
    def loss_fn(params, key):
        return sum(((params[k] - centre[k]) ** 2 * weights[k]).sum() for k in params)
    return loss_fn


def test_adam_step_matches_torch_adam_then_clamp_on_its_rows_only():
    gen = torch.Generator().manual_seed(3)
    params = {"mat_kd": torch.rand(6, 3, generator=gen), "mat_ka": torch.rand(6, 3, generator=gen)}
    centre = {k: torch.rand(6, 3, generator=gen) * 1.6 - 0.3 for k in params}
    weights = {k: torch.rand(6, 3, generator=gen) + 0.1 for k in params}
    rows = [2, 4]
    opts = dict(lr=0.2, betas=(0.8, 0.99), eps=1e-6, bounds=(0.0, 1.0))
    step = G.make_adam_step(_quadratic(weights, centre), rows=rows, **opts)
    mine = {k: v.clone() for k, v in params.items()}
    theirs = {k: v[rows].clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(theirs.values(), lr=opts["lr"], betas=opts["betas"], eps=opts["eps"])
    state, clamped = None, 0
    for i in range(8):
        mine, loss, state = step(mine, make_key(i), state)
        opt.zero_grad()
        full = {k: params[k].clone().index_copy(0, torch.tensor(rows), theirs[k]) for k in params}
        _quadratic(weights, centre)(full, None).backward()
        opt.step()
        with torch.no_grad():
            for v in theirs.values():
                clamped += int(((v < 0.0) | (v > 1.0)).sum())
                v.clamp_(*opts["bounds"])
        assert state.t == i + 1
        for k in params:
            torch.testing.assert_close(mine[k][rows], theirs[k].detach(), rtol=1e-6, atol=1e-7)
            others = [r for r in range(6) if r not in rows]
            assert torch.equal(mine[k][others], params[k][others])
            torch.testing.assert_close(state.m[k], opt.state[theirs[k]]["exp_avg"],
                                       rtol=1e-6, atol=1e-9)
            torch.testing.assert_close(state.v[k], opt.state[theirs[k]]["exp_avg_sq"],
                                       rtol=1e-6, atol=1e-12)
    assert clamped > 0  # the bounds were reached, so the clamp was exercised


def test_three_steps_of_a_job_match_the_reference_step_by_step():
    ctx = _context(2**31 + 977)
    _, step, params, target = _problem(ctx)
    row, opts = D.material(ctx), D.adam_options(ctx)
    scene, cam, est = D.reference_scene(ctx)
    kd, m, v = np.asarray(ctx.config["start"], np.float64), np.zeros(3), np.zeros(3)
    state = None
    for g in range(3):
        params, loss, state = step(params, fold_in(make_key(ctx.seed32), g), state)
        want_loss, grad = RI.loss_and_grad(scene, cam, est, D.step_key(ctx, g), SPP, target,
                                           row, kd)
        kd, m, v = RI.adam(kd, m, v, g + 1, grad, **opts)
        assert abs(float(loss) - want_loss) <= TOL * want_loss
        assert _rel(params["mat_kd"][row], kd) <= TOL
        assert _rel(state.m["mat_kd"][0], m) <= TOL and _rel(state.v["mat_kd"][0], v) <= TOL
    assert state.t == 3 and not np.allclose(kd, ctx.config["start"])


def test_a_step_records_its_spans_and_counters(tmp_path):
    ctx = _context(5, width=16, height=12, spp_per_pass=1)
    _, step, params, _ = _problem(ctx)
    with profiling.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state = None
            for g in range(2):
                params, _, state = step(params, fold_in(make_key(ctx.seed32), g), state)
    traced = profiling.traced()
    for r in (rec, traced):
        assert r["steps"] == 2 and r["passes"] == 0
        assert {k: r["spans"][k][0] for k in r["spans"]} == {
            "grad.step": 2, "grad.forward": 2, "grad.backward": 2, "grad.update": 2}
        assert r["launches"] == {}  # the CPU path launches no kernel
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = program_spans(tmp_path / "trace.json")
    steps = [s for s in spans if s[0] == "grad.step"]
    assert [s[1] for s in steps] == [{"step": 1}, {"step": 2}]
    for name in ("grad.forward", "grad.backward", "grad.update"):
        inner = [s for s in spans if s[0] == name]
        assert len(inner) == 2
        assert all(a[2] <= b[2] and b[3] <= a[3] for a, b in zip(steps, inner)), name


def _keys(device):
    key = fold_in(make_key(3_900_000_001), 17)
    staged = DeviceKey.stage(key, torch.zeros(2, dtype=torch.int32, device=device))
    return key, staged


def test_a_device_key_draws_its_host_keys_streams():
    key, staged = _keys("cpu")
    assert staged.host() == key
    for words in ((0xFFFFFFFF, 0x80000000), (0x80000000, 0), (0, 0xFFFFFFFF)):  # sign bits
        assert DeviceKey.stage(words, torch.zeros(2, dtype=torch.int32)).host() == words
    for folds in ((), (3,), (3, (1 << 29) + 2)):
        host, dev = key, staged
        for d in folds:
            host, dev = fold_in(host, d), fold_in(dev, d)
        assert dev.host() == host
        ids = (0, 1, 3, 1 << 30)
        assert torch.equal(rng.stream_uniforms(dev, ids, 77, "cpu"),
                           rng.stream_uniforms(host, ids, 77, "cpu"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_keyed_draws_equal_the_host_folded_ones_on_the_card(card):
    key, staged = _keys(card)
    for folds in ((), (2,), (2, (1 << 29) + 1, 5)):
        host, dev = key, staged
        for d in folds:
            host, dev = fold_in(host, d), fold_in(dev, d)
        for ids in ((0, 1), (4, 5, 7), (1 << 30, (1 << 30) + 1, 8, 9)):
            assert torch.equal(rng.stream_uniforms(dev, ids, 480_001, card),
                               rng.stream_uniforms(host, ids, 480_001, card)), (folds, ids)
    # "cuda" names the current card, on which the key's base lies.
    assert torch.equal(rng.stream_uniforms(staged, (0, 1), 1000, "cuda"),
                       rng.stream_uniforms(key, (0, 1), 1000, "cuda"))


@pytest.mark.cuda
def test_the_graphed_loss_replays_the_eager_one_on_the_card(card):
    ctx = _context(7, "cuda")
    loss_fn, _, params, _ = _problem(ctx)
    key = fold_in(make_key(3_900_000_001), 17)
    graphed, launches = G.graphed_loss(loss_fn, params, key)
    assert {k: launches.get(k) for k in ("B1", "B2", "B3", "B3s")} == dict.fromkeys(
        ("B1", "B2", "B3", "B3s"), 8 * SPP)  # 32 rows: every B3 call takes the small path
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
    _, step, params, _ = _problem(ctx, target)
    params, _, state = step(params, make_key(1))  # loads the kernels, captures the graphs
    torch.cuda.synchronize()
    with profiling.recording() as rec:
        torch.cuda.set_sync_debug_mode("error")
        try:
            params, loss, state = step(params, make_key(2), state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    segments = 8 * int(ctx.traffic["spp_per_pass"])
    assert rec["steps"] == 1
    assert {k: rec["launches"].get(k) for k in ("B1", "B2", "B3", "B3s")} == dict.fromkeys(
        ("B1", "B2", "B3", "B3s"), segments)
    assert rec["launches"]["RNG"] == segments + int(ctx.traffic["spp_per_pass"])
    assert torch.isfinite(loss).item() and state.t == 2
