"""The fused kernels compiled for the GPU (not interpreted) against the
scan engine on the same card.

Marked `gpu`: the `gpu` fixture skips them where JAX finds no GPU. On a
machine with one: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu -n 0
tests/test_gpu_kernels.py
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cpecan_tpu.models.state_machine import state_machine3, state_machine5
from cpecan_tpu.ops import fb_batch, fb_wavefront

from test_wavefront_grid import _banded_batch


@pytest.mark.gpu
@pytest.mark.parametrize("width", [8, 64, 512])
@pytest.mark.parametrize("sm_factory", [state_machine5, state_machine3])
@pytest.mark.parametrize("mode", fb_wavefront.MODES)
def test_compiled_kernels_match_scan(gpu, mode, sm_factory, width):
    rng = np.random.default_rng(width)
    B = 5
    args = [jax.device_put(a, gpu) for a in _banded_batch(rng, B, 256, width)]
    rl = jax.device_put(np.arange(B) % 2 == 1, gpu)
    rr = jax.device_put(np.arange(B) % 3 == 2, gpu)
    params = jax.device_put(sm_factory().device_params(), gpu)
    got = jax.device_get(fb_wavefront.fb_pass_batch_wavefront(
        params, *args, rl, rr, mode=mode, width=width))
    ref = jax.device_get(fb_batch.fb_pass_batch_scan(
        params, *args, rl, rr, mode=mode, width=width))
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["log_fwd"], ref["log_fwd"], atol=1e-5)
    np.testing.assert_allclose(got["mf"], ref["mf"], atol=1e-5)
    for k in ("post_match", "post_gap_x", "post_gap_y"):
        if k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-5)
    for k in ("trans", "emis"):
        if k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6)
