"""The exact streaming engine against the dense two-pass pass of the same
pair, over window size x mode x state machine."""

import numpy as np
import pytest

from cpecan_tpu.models.state_machine import state_machine3, state_machine5

from test_streaming import _case, _stream, _two_pass


@pytest.mark.parametrize("window", [64, 200])
@pytest.mark.parametrize("mode", ["posterior_match", "posterior_all",
                                  "expectation"])
@pytest.mark.parametrize("sm_factory", [state_machine5, state_machine3])
def test_streaming_matches_dense_grid(window, mode, sm_factory):
    x, y, band = _case(n=140, seed=window + len(mode))
    sm = sm_factory()
    W = max(8, band.frame_width())
    ref, L = _two_pass(sm, x, y, band, mode, W)
    got = _stream(sm, x, y, band, mode, W, window)
    assert got["windows"] == -(-L // window)
    np.testing.assert_allclose(got["mf"][: L + 1], ref["mf"][: L + 1],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["mb"][1: L + 1], ref["mb"][1: L + 1],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["total_raw"][1: L + 1],
                               ref["total_raw"][1: L + 1],
                               rtol=1e-4, atol=1e-5)
    lf_ref = ref["log_fwd"] + np.sum(ref["mf"][: L + 1], dtype=np.float64)
    lf_got = got["log_fwd"] + np.sum(got["mf"][: L + 1], dtype=np.float64)
    assert lf_got == pytest.approx(lf_ref, rel=1e-6, abs=1e-5)
    if mode == "expectation":
        np.testing.assert_allclose(got["trans"], ref["trans"], rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(got["emis"], ref["emis"], rtol=1e-4,
                                   atol=1e-7)
        return
    for key in got["post_entries"]:
        vals, ks, js = got["post_entries"][key]
        dense = np.zeros_like(ref[key])
        dense[ks, js] = vals
        np.testing.assert_allclose(dense[: L + 1], ref[key][: L + 1],
                                   rtol=2e-4, atol=1e-6)
