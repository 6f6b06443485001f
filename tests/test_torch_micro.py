"""The selection-step microkernels' plain versions (B12-B14) against a
numpy transcription of the JAX package's kernel bodies
(``tools/kernel_micro.py:105-187``, nested in its ``main()`` and not
importable), on the CPU.

The transcription follows the bodies grid step by grid step: per chunk c,
p = ws[:, c·6tc : (c+1)·6tc]ᵀ · rays; ``body_v3``'s ``_epilogue`` with
``jnp.minimum``'s NaN-propagating chain (``np.minimum``), the chunk's min
and its first index, a strict ``<`` across chunks; ``body_matmul_only``
and ``body_matmul_bf16`` a running min cast to int32. Two choices of the
port are written into it: p is summed in float32 over the 48 rows in
order (the MXU's order is its own), and the accept chain's
``pl.reciprocal(approx=True)`` with its Newton step is the IEEE
reciprocal. With those, port and transcription agree bit for bit, which
is what the tests assert. Inputs: seeded N(0, 1) values rounded to bf16,
some triangles' columns zeroed (w = 0: t is ±inf or NaN and must never
win).

``testing.compare_micro``, the rounding rule that holds B12's tensor-core
kernel to this plain version on the card, is tested here on synthetic
results: p summed in another order, or moved by up to its bound E,
passes; a winner replaced, a miss for a clear hit, or a min moved by one,
fails.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu_torch.ops import selection_micro as SM
from montecarlopathtracer_tpu_torch.testing import cap_torch_threads, compare_micro
from montecarlopathtracer_tpu_torch.tools import kernel_micro
from montecarlopathtracer_tpu_torch.utils import profiling

cap_torch_threads()

BIG = np.float32(3.0e38)
R, T, TC = 600, 256, 128  # rays, triangles, chunk: two chunks


def _bf16(x):
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    ws = _bf16(rng.normal(size=(SM.K, 6 * T)).astype(np.float32))
    for j in (3, 130, 255):  # triangles whose six columns are zero
        c, tl = divmod(j, TC)
        ws[:, [c * 6 * TC + k * TC + tl for k in range(6)]] = 0.0
    rays = _bf16(rng.normal(size=(SM.K, R)).astype(np.float32))
    return ws, rays


def _contract_np(ws_c, rays):
    p = ws_c[0][:, None] * rays[0][None, :]
    for k in range(1, SM.K):
        p = (p + ws_c[k][:, None] * rays[k][None, :]).astype(np.float32)
    return p


def _epilogue_np(p, tc, ci, bt, bi):
    """``_epilogue`` (kernel_micro.py:143-165) with the IEEE reciprocal."""
    opx, opy, q = p[0:tc], p[tc:2 * tc], p[2 * tc:3 * tc]
    dpx, dpy, w = p[3 * tc:4 * tc], p[4 * tc:5 * tc], p[5 * tc:6 * tc]
    with np.errstate(all="ignore"):
        r = np.float32(1.0) / w
        t = q * r
        beta = opx + t * dpx
        gamma = opy + t * dpy
        m = np.minimum(np.minimum(beta, gamma), t)
        m = np.minimum(m, np.float32(1.0) - (beta + gamma))
        tm = np.where(m > 0.0, t, BIG).astype(np.float32)
    c_min = tm.min(axis=0)
    col = np.arange(tc)[:, None]
    c_idx = np.where(tm <= c_min[None, :], col, 2**31 - 1).min(axis=0) + ci * tc
    better = c_min < bt
    return np.where(better, c_min, bt), np.where(better, c_idx, bi)


def _select_np(block, nc, tc, n):
    """The grid over chunks for ``n`` rays: ``block(ci)`` is p f32[6tc, n]."""
    bt = np.full(n, BIG, np.float32)
    bi = np.full(n, 2**31 - 1, np.int64)
    for ci in range(nc):
        bt, bi = _epilogue_np(block(ci), tc, ci, bt, bi)
    return np.where(bt < BIG, bi, -1)


def _running_min_np(ws, rays, bf16_out):
    """``body_matmul_only`` / ``body_matmul_bf16``: int32(min of p)."""
    bt = None
    for ci in range(T // TC):
        p = _contract_np(ws[:, ci * 6 * TC:(ci + 1) * 6 * TC], rays)
        m = (_bf16(p) if bf16_out else p).min(axis=0)
        bt = m if bt is None else np.minimum(bt, m)
    return bt.astype(np.int32)


def _as_bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def test_full_matches_transcription(data):
    ws, rays = data
    want = _select_np(lambda ci: _contract_np(ws[:, ci * 6 * TC:(ci + 1) * 6 * TC], rays),
                      T // TC, TC, R)
    before = profiling.launches()
    got = SM.selection_micro(_as_bf16(ws), _as_bf16(rays), TC, "full")
    assert got.dtype == torch.int32 and got.shape == (R,)
    assert np.array_equal(got.numpy(), want)
    assert 0.05 < (want >= 0).mean() and not np.isin(want, (3, 130, 255)).any()
    assert profiling.launches() - before == {}  # CPU tensors: the plain version


@pytest.mark.parametrize("variant", ["matmul_only", "matmul_bf16"])
def test_running_min_matches_transcription(data, variant):
    ws, rays = data
    want = _running_min_np(ws, rays, variant == "matmul_bf16")
    got = SM.selection_micro(_as_bf16(ws), _as_bf16(rays), TC, variant)
    assert np.array_equal(got.numpy(), want)
    assert (want < 0).all()  # the least of 1,536 N(0, 1)-ish sums is negative


def test_epilogue_resident_matches_transcription(data):
    ws, rays = data
    p_all = np.concatenate([_contract_np(ws[:, c * 6 * TC:(c + 1) * 6 * TC], rays)
                            for c in range(T // TC)])  # [6T, R], block (c, i) at rows c·6tc
    want = _select_np(lambda ci: p_all[ci * 6 * TC:(ci + 1) * 6 * TC], T // TC, TC, R)
    got = SM.epilogue_only(torch.from_numpy(p_all), TC)
    assert np.array_equal(got.numpy(), want)
    # The resident epilogue on the contraction's p is the full variant.
    full = SM.selection_micro(_as_bf16(ws), _as_bf16(rays), TC, "full")
    assert torch.equal(got, full)


@pytest.mark.parametrize("rt", [128, 256])
def test_epilogue_shared_matches_transcription(rt):
    rng = np.random.default_rng(5)
    p_blk = rng.normal(size=(6 * TC, rt)).astype(np.float32)
    p_blk[5 * TC + 7] = 0.0  # w = 0 for triangle 7 of every chunk
    # Every (ray tile, chunk) step reads the same block (index map (0, 0)).
    want = np.concatenate([_select_np(lambda ci: p_blk, T // TC, TC, rt)
                           for _ in range(-(-R // rt))])[:R]
    got = SM.epilogue_shared(torch.from_numpy(p_blk), T, R)
    assert np.array_equal(got.numpy(), want)
    assert (want < TC).all()  # the first chunk's equal t wins every tie


def test_refusals(data):
    ws, rays = data
    with pytest.raises(ValueError, match="variant"):
        SM.selection_micro(_as_bf16(ws), _as_bf16(rays), TC, "v2")
    with pytest.raises(ValueError, match="bf16"):
        SM.selection_micro(torch.from_numpy(ws), _as_bf16(rays), TC)
    with pytest.raises(ValueError, match="multiple"):
        SM.selection_micro(_as_bf16(ws), _as_bf16(rays), 96)
    with pytest.raises(ValueError, match="chunks"):
        SM.epilogue_shared(torch.zeros(6 * TC, 8), T + 64, 8)


def test_kernel_micro_tool_runs_on_cpu(capsys):
    assert kernel_micro.main(["--rays", "256", "--tris", "256", "--iters", "1",
                              "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in rows] == ["v3_full", "matmul_only_f32out",
                                            "matmul_only_bf16out", "epilogue_only",
                                            "epilogue_resident"]
    assert all(r["t_chunk"] == 256 and r["ms"] > 0 and r["device"] == "cpu" for r in rows)
    assert kernel_micro.main(["--tris", "100", "--device", "cpu"]) == 2
    assert kernel_micro.main(["--iters", "0", "--device", "cpu"]) == 2


def test_kernel_micro_keeps_its_inputs_and_outputs_on_cpu():
    keep = {}
    kernel_micro.run(rays=256, tris=256, iters=1, device="cpu", keep=keep)
    ws, x, p_blk, p_all, tc = (keep[k] for k in ("ws", "rays", "p_blk", "p_all", "t_chunk"))
    assert ws.shape == (SM.K, 6 * 256) and x.shape == (SM.K, 256) and p_all.shape == (1536, 256)
    out = keep["out"]
    assert torch.equal(out["v3_full"], SM.selection_micro_ref(ws, x, tc, "full"))
    assert torch.equal(out["matmul_only_bf16out"], SM.selection_micro_ref(ws, x, tc,
                                                                          "matmul_bf16"))
    assert torch.equal(out["epilogue_resident"], SM.epilogue_only_ref(p_all, tc))
    assert torch.equal(out["epilogue_only"], SM.epilogue_shared_ref(p_blk, 256, 256))


@pytest.fixture(scope="module")
def perturbed():
    """ws, rays (4,000 rays, 128 triangles in chunks of 64), float64 p
    [6T, R] and the rule's bound E per ray."""
    rng = np.random.default_rng(9)
    ws = _as_bf16(rng.normal(size=(SM.K, 6 * 128)).astype(np.float32))
    rays = _as_bf16(rng.normal(size=(SM.K, 4000)).astype(np.float32))
    p = ws.double().T @ rays.double()
    e = 48 * 2 * 2.0 ** -23 * (ws.double().abs().T @ rays.double().abs()).amax(0)
    return ws, rays, p, e


def _reordered_min(ws, rays, bf16_out):
    """int32(min p) with p summed in f32 over the rows in reverse order."""
    wf, xf = ws.float(), rays.float()
    p = wf[SM.K - 1][:, None] * xf[SM.K - 1][None, :]
    for k in range(SM.K - 2, -1, -1):
        p = p + wf[k][:, None] * xf[k][None, :]
    if bf16_out:
        p = p.to(torch.bfloat16).float()
    return p.amin(0).to(torch.int32)


@pytest.mark.parametrize("variant", ["matmul_only", "matmul_bf16"])
def test_compare_micro_running_min(perturbed, variant):
    ws, rays, p, e = perturbed
    want = SM.selection_micro_ref(ws, rays, 64, variant)
    assert compare_micro(ws, rays, 64, variant, want, want)["ok"]
    reordered = _reordered_min(ws, rays, variant == "matmul_bf16")
    assert compare_micro(ws, rays, 64, variant, reordered, want, step=1000)["ok"]
    low = p.amin(0)
    moved = (low + 0.5 * e * torch.where(low.frac().abs() < 0.5, 1.0, -1.0)).trunc()
    assert compare_micro(ws, rays, 64, variant, moved.to(torch.int32), want)["ok"]
    rep = compare_micro(ws, rays, 64, variant, want + 1, want)
    assert not rep["ok"] and rep["n_out_of_bound"] > 3000, rep  # bf16: E holds an ulp


def test_compare_micro_full(perturbed):
    ws, rays, p, e = perturbed
    want = SM.selection_micro_ref(ws, rays, 64, "full")
    assert compare_micro(ws, rays, 64, "full", want, want)["ok"]
    g = torch.Generator().manual_seed(8)
    noise = (torch.rand(p.shape, generator=g, dtype=torch.float64) * 2 - 1) * e  # within E
    moved = SM.epilogue_only_ref((p + noise).float(), 64)
    rep = compare_micro(ws, rays, 64, "full", moved, want)
    assert rep["ok"] and rep["n_idx_mismatch"] > 0, rep
    hits = torch.nonzero(want >= 0)[:, 0]
    assert hits.shape[0] > 100
    for wrong in (-1, "other"):
        got = want.clone()
        got[hits[:3]] = -1 if wrong == -1 else (want[hits[:3]] + 37) % 128
        rep = compare_micro(ws, rays, 64, "full", got, want)
        assert not rep["ok"] and rep["n_bad"] >= 2, (wrong, rep)
