"""A run of each cell on the CPU, at a small size, with its timed path
sound comes out correct; with the timed path broken underneath (a pass
that leaves the film unchanged, half of the batch left out, an answer
altered where it is produced), and with the controls (the reference in
bfloat16 in the program's place), it comes out not correct."""

import dataclasses

import pytest

import perfbench_testing as PT
from perfbench_testing import card  # noqa: F401 (the fixture)

CELLS = ("cornell_box.cvmc_launch",)
FAST = {"cornell_box.cvmc_launch": {"spp_per_pass": 4}}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, trace):
    rc, line, err = PT.run_cell(cell, overrides=FAST[cell], trace=trace)
    assert rc == 0, err
    assert line["correct"] is True, err
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    if trace:
        assert "breakdown" in line and "window_s" in line["device"]
    else:
        assert "setup_s" in line["metrics"]


def _unchanged_film(drv):
    from montecarlopathtracer_tpu_torch.render import renderer

    def keep(film, mean, weight):
        return film

    renderer.film_update = keep


def _half_batch(drv):
    from montecarlopathtracer_tpu_torch.render.renderer import Renderer

    whole = Renderer._pass

    def half(self, key):
        s = self.settings
        self.settings = dataclasses.replace(s, spp_per_pass=max(1, s.spp_per_pass // 2))
        try:
            return whole(self, key)
        finally:
            self.settings = s

    Renderer._pass = half


def _scaled(factor):
    def plant(drv):
        from montecarlopathtracer_tpu_torch.render import renderer

        update = renderer.film_update

        def altered(film, mean, weight):
            return update(film, mean * factor, weight)

        renderer.film_update = altered

    return plant


FAULTS = {"unchanged": _unchanged_film, "half_batch": _half_batch, "altered": _scaled(1.1),
          "biased": _scaled(1.02)}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_render_path_is_not_correct(cell, fault):
    from montecarlopathtracer_tpu_torch.render import renderer

    saved = (renderer.film_update, renderer.Renderer._pass)
    try:
        rc, line, err = PT.run_cell(cell, patch=FAULTS[fault], overrides=FAST[cell])
    finally:
        renderer.film_update, renderer.Renderer._pass = saved
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    from perfbench import control, harness

    ctx = harness.load_context(cell, PT.SEED, 0.3, False, "cpu", {**PT.SMALL, **FAST[cell]})
    readings = control.render_control(ctx, passes=2)
    assert set(readings) == set(control.CONTROLS)
    assert all(v > float(ctx.limits["film_gap"]) for v in readings.values()), readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(card, capsys, cell):
    from perfbench import run

    rc = run.main(["--workload", cell, "--seed", str(PT.SEED), "--seconds", "2",
                   "--trace", "0"])
    assert rc == 0
    assert '"correct": true' in capsys.readouterr().out.strip().splitlines()[-1]
