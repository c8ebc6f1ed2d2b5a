"""Parity tests: the fused GPU kernels vs the scan engine oracle.

The kernels (ops/fb_wavefront.py) implement the identical
scaled-probability recurrence as ops/fb.py, so the scan engine serves as
the numerical oracle. On the CPU test backend the kernels execute in the
Pallas interpreter (interpret=True) — the same kernel code that Triton
compiles for the GPU — and a second set of tests lowers them for CUDA
(Pallas -> Triton IR) without a card.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cpecan_tpu.models.state_machine import state_machine3, state_machine5
from cpecan_tpu.ops import fb_batch, fb_wavefront
from cpecan_tpu.ops.band import construct_band, full_band, pad_band
from cpecan_tpu.utils.symbols import encode


def _random_batch(rng, B=3, P=64, W=32, n=24):
    sxs, sys_, offs, wids, lxs, lys = [], [], [], [], [], []
    for i in range(B):
        nx = int(n + rng.integers(-4, 4))
        ny = int(n + rng.integers(-4, 4))
        sx = np.zeros(P, np.int32)
        sy = np.zeros(P, np.int32)
        qx = "".join("ACGTN"[j] for j in rng.integers(0, 5, nx))
        qy = "".join("ACGT"[j] for j in rng.integers(0, 4, ny))
        sx[:nx] = encode(qx)
        sy[:ny] = encode(qy)
        if i == 0:
            band = full_band(nx, ny)
        else:
            anchors = [(k, min(k, ny - 2))
                       for k in range(4, min(nx, ny) - 4, 6)]
            band = construct_band(anchors, nx, ny, 6)
        o, w, L = pad_band(band, P, W)
        sxs.append(sx)
        sys_.append(sy)
        offs.append(o)
        wids.append(w)
        lxs.append(nx)
        lys.append(ny)
    return (np.stack(sxs), np.stack(sys_), np.stack(offs), np.stack(wids),
            np.asarray(lxs, np.int32), np.asarray(lys, np.int32))


@pytest.mark.parametrize("sm_factory,mode", [
    (state_machine5, "forward"),
    (state_machine5, "posterior_all"),
    (state_machine3, "posterior_match"),
    (state_machine5, "expectation"),
    (state_machine3, "expectation"),
])
def test_wavefront_matches_scan_engine(sm_factory, mode):
    rng = np.random.default_rng(42)
    W = 32
    args = _random_batch(rng, W=W)
    rl = np.array([False, True, False])
    rr = np.array([False, False, True])
    params = sm_factory().device_params()

    ref = fb_batch.fb_pass_batch_scan(
        params, *[jnp.asarray(a) for a in args], jnp.asarray(rl),
        jnp.asarray(rr), mode=mode, width=W)
    new = fb_wavefront.fb_pass_batch_wavefront(
        params, *args, rl, rr, mode=mode, width=W, interpret=True)

    np.testing.assert_allclose(np.asarray(new["log_fwd"]),
                               np.asarray(ref["log_fwd"]),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(new["mf"]), np.asarray(ref["mf"]),
                               rtol=1e-4, atol=2e-5)
    keys = ()
    if mode == "posterior_match":
        keys = ("post_match",)
    elif mode == "posterior_all":
        keys = ("post_match", "post_gap_x", "post_gap_y")
    for k in keys:
        np.testing.assert_allclose(np.asarray(new[k]), np.asarray(ref[k]),
                                   rtol=1e-3, atol=2e-5)
    if mode == "expectation":
        np.testing.assert_allclose(np.asarray(new["trans"]),
                                   np.asarray(ref["trans"]),
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(np.asarray(new["emis"]),
                                   np.asarray(ref["emis"]),
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(np.asarray(new["mb"]),
                                   np.asarray(ref["mb"]),
                                   rtol=1e-4, atol=2e-5)
        lx, ly = args[4], args[5]
        for i in range(len(lx)):
            L = int(lx[i] + ly[i])
            np.testing.assert_allclose(
                np.asarray(new["total_raw"])[i, 1:L + 1],
                np.asarray(ref["total_raw"])[i, 1:L + 1],
                rtol=1e-4, atol=2e-5)


def test_wavefront_nonzero_transitions():
    t5 = np.asarray(state_machine5().device_params()["t"])
    nz5 = fb_wavefront.nonzero_transitions(t5)
    assert len(nz5) == 13  # the reference's 13 active 5-state transitions
    t3 = np.asarray(state_machine3().device_params()["t"])
    nz3 = fb_wavefront.nonzero_transitions(t3)
    assert len(nz3) == 9
    # middle-class transitions land only in the match state (the bridge
    # restructuring in the kernels relies on this)
    assert all(t == 0 for c, f, t in nz5 if c == 1)
    assert all(t == 0 for c, f, t in nz3 if c == 1)


def test_dispatch_scan_on_cpu():
    # On the CPU test backend "auto" must pick the scan engine
    import os
    assert os.environ.get("CPECAN_TPU_ENGINE", "auto") != "wavefront"
    params = state_machine5().device_params()
    sx = jnp.zeros((2, 8), jnp.int32)
    assert fb_batch._select_engine(
        params, sx, "expectation", None, None) == "scan"


def _cuda_lowering(fn, *args):
    """Lower `fn` for CUDA on this host: runs the Pallas -> Triton IR
    lowering of every kernel (the GPU compiler itself runs only on a
    card)."""
    from jax import export

    return export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*args).mlir_module()


@pytest.mark.parametrize("sm_factory", [state_machine5, state_machine3])
@pytest.mark.parametrize("mode", fb_wavefront.MODES)
def test_kernels_lower_for_cuda(sm_factory, mode):
    params = sm_factory().device_params()
    nz = fb_wavefront.nonzero_transitions(np.asarray(params["t"]))
    B, P, W = 3, 64, 64
    args = ((jnp.zeros((B, P), jnp.int32),) * 2
            + (jnp.zeros((B, P + 1), jnp.int32),) * 2
            + (jnp.zeros(B, jnp.int32),) * 2 + (jnp.zeros(B, bool),) * 2)
    group, warps = fb_wavefront.tiles(W)
    text = _cuda_lowering(
        lambda *a: fb_wavefront._wavefront_jit(
            params, *a, nz=nz, mode=mode, width=W, group=group, warps=warps,
            interpret=False), *args)
    assert text.count("xla.gpu.triton") == (1 if mode == "forward" else 2)


@pytest.mark.parametrize("width,expect", [
    (1, 8), (8, 8), (9, 16), (41, 64), (64, 64), (65, 128), (1000, 1024)])
def test_block_width_and_tiles(width, expect):
    W = fb_wavefront.block_width(width)
    assert W == expect
    group, warps = fb_wavefront.tiles(W)
    assert group >= 1 and (group & (group - 1)) == 0
    assert 1 <= warps <= 8 and group * W >= 32 * min(warps, 2)


_SELECT_CASES = [
    # (on_gpu, engine, mode, width, mesh devices, expected)
    (False, None, "posterior_match", 64, 1, "scan"),
    (False, "scan", "expectation", 64, 1, "scan"),
    (True, None, "posterior_match", 64, 1, "wavefront"),
    (True, None, "expectation", 64, 1, "wavefront"),
    (True, "wavefront", "forward", 8, 1, "wavefront"),
    (True, "scan", "posterior_all", 64, 1, "scan"),
    (True, None, "posterior_match", 2048, 1, "scan"),
    (True, None, "expectation", 64, 2, "wavefront_sharded"),
    (False, None, "expectation", 64, 2, "scan_sharded"),
]


@pytest.mark.parametrize("on_gpu,engine,mode,width,n_dev,expected",
                         _SELECT_CASES)
def test_engine_choice_per_platform(monkeypatch, on_gpu, engine, mode,
                                    width, n_dev, expected):
    from cpecan_tpu.parallel.mesh import data_mesh

    monkeypatch.setattr(fb_batch, "_on_gpu", lambda: on_gpu)
    monkeypatch.delenv("CPECAN_TPU_ENGINE", raising=False)
    params = state_machine5().device_params()
    sx = jnp.zeros((2, 8), jnp.int32)
    mesh = data_mesh(n_dev) if n_dev > 1 else None
    assert fb_batch._select_engine(params, sx, mode, mesh, None, engine,
                                   width) == expected


@pytest.mark.parametrize("engine", ["wavefront", "interpret", "tpu"])
def test_engine_choice_refuses_off_gpu(monkeypatch, engine):
    """No engine value reaches the kernels (or an interpreter) off a GPU."""
    monkeypatch.setattr(fb_batch, "_on_gpu", lambda: False)
    params = state_machine5().device_params()
    with pytest.raises(ValueError):
        fb_batch._select_engine(params, jnp.zeros((2, 8), jnp.int32),
                                "posterior_match", None, None, engine, 64)


@pytest.mark.parametrize("mode", ["posterior_match", "expectation"])
def test_batch_slicing_matches_unsliced(monkeypatch, mode):
    """Batches whose flat kernel buffers would overflow int32 offsets run
    in group-aligned slices; outputs must match the unsliced call."""
    rng = np.random.default_rng(7)
    B = 6
    args = _random_batch(rng, B=B, W=32)
    rl = np.zeros(B, bool)
    rr = np.zeros(B, bool)
    params = state_machine5().device_params()
    whole = fb_wavefront.fb_pass_batch_wavefront(
        params, *args, rl, rr, mode=mode, width=32, interpret=True)
    # room for two pairs' F rows per call: three slices
    per_pair = args[2].shape[1] * 5 * 32
    monkeypatch.setattr(fb_wavefront, "_MAX_INDEX", 2 * per_pair)
    sliced = fb_wavefront.fb_pass_batch_wavefront(
        params, *args, rl, rr, mode=mode, width=32, interpret=True)
    assert set(sliced) == set(whole)
    for k in whole:
        np.testing.assert_allclose(np.asarray(sliced[k]),
                                   np.asarray(whole[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
