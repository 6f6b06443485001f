"""The port's CUDA kernel on the card: builds, launches, agrees with its
plain-torch version, counts its launches and refuses what it cannot
take. Every test here needs an NVIDIA Hopper GPU and nvcc, and skips
elsewhere. This file imports no JAX; run it on the GPU machine, from the
repository root, without the JAX-pinning conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from montecarlopathtracer_tpu_torch.models import cornell
from montecarlopathtracer_tpu_torch.ops import segment_fused as F
from montecarlopathtracer_tpu_torch.ops.rng import make_key, stream_uniform
from montecarlopathtracer_tpu_torch.render.integrator import (
    TraceConfig,
    render_sample_batch,
)
from montecarlopathtracer_tpu_torch.testing import compare_images, compare_segment

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
