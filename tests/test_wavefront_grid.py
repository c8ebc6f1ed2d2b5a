"""The fused kernels (interpreted) against the scan engine over mode x
state machine x width bucket, with batches that do not fill the last
program's pair group."""

import numpy as np
import pytest

import jax.numpy as jnp

from cpecan_tpu.models.state_machine import state_machine3, state_machine5
from cpecan_tpu.ops import fb_batch, fb_wavefront

from cpecan_tpu.ops.band import construct_band, pad_band
from cpecan_tpu.utils.symbols import encode


def _banded_batch(rng, B, P, width):
    """B random pairs (lengths differ by up to 3) on anchored bands that
    fill but fit `width` slots; symbols include N."""
    cols = [[] for _ in range(6)]
    for _ in range(B):
        nx = int(rng.integers(P // 2 - 4, P // 2))
        ny = nx - int(rng.integers(0, 4))
        anchors = [(k, k) for k in range(2, ny - 2, 5)]
        e = width - width % 2
        while True:
            band = construct_band(anchors, nx, ny, e)
            if band.frame_width() <= width or e == 0:
                break
            e -= 2
        o, w, _ = pad_band(band, P, width)
        sx = np.zeros(P, np.int32)
        sy = np.zeros(P, np.int32)
        sx[:nx] = encode("".join("ACGTN"[j] for j in rng.integers(0, 5, nx)))
        sy[:ny] = encode("".join("ACGT"[j] for j in rng.integers(0, 4, ny)))
        for col, v in zip(cols, (sx, sy, o, w, nx, ny)):
            col.append(v)
    return tuple(np.stack(c) if i < 4 else np.asarray(c, np.int32)
                 for i, c in enumerate(cols))


@pytest.mark.parametrize("width", [8, 16, 64])
@pytest.mark.parametrize("sm_factory", [state_machine5, state_machine3])
@pytest.mark.parametrize("mode", fb_wavefront.MODES)
def test_kernel_grid_matches_scan(mode, sm_factory, width):
    group, _ = fb_wavefront.tiles(fb_wavefront.block_width(width))
    B = group + 1 if group > 1 else 3  # last group partly empty when G > 1
    rng = np.random.default_rng(width * 7 + len(mode))
    args = _banded_batch(rng, B, 32, width)
    rl = np.arange(B) % 2 == 1
    rr = np.arange(B) % 3 == 2
    params = sm_factory().device_params()
    ref = fb_batch.fb_pass_batch_scan(
        params, *[jnp.asarray(a) for a in args], jnp.asarray(rl),
        jnp.asarray(rr), mode=mode, width=width)
    got = fb_wavefront.fb_pass_batch_wavefront(
        params, *args, rl, rr, mode=mode, width=width, interpret=True)
    assert set(got) == set(ref)
    np.testing.assert_allclose(np.asarray(got["log_fwd"]),
                               np.asarray(ref["log_fwd"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got["mf"]), np.asarray(ref["mf"]),
                               rtol=1e-5, atol=1e-5)
    if mode == "forward":
        return
    np.testing.assert_allclose(np.asarray(got["mb"]), np.asarray(ref["mb"]),
                               rtol=1e-5, atol=1e-5)
    lx, ly = args[4], args[5]
    for i in range(B):
        L = int(lx[i] + ly[i])
        np.testing.assert_allclose(np.asarray(got["total_raw"])[i, 1:L + 1],
                                   np.asarray(ref["total_raw"])[i, 1:L + 1],
                                   rtol=1e-5, atol=1e-5)
    for k in ("post_match", "post_gap_x", "post_gap_y"):
        if k in ref:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                       atol=1e-5)
    for k in ("trans", "emis"):
        if k in ref:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                       rtol=1e-4, atol=1e-6)
