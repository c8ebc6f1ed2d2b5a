"""Cross-checks of the banded FB engine against the naive oracle and
the reference's golden fixtures."""

import numpy as np
import pytest

from cpecan_tpu.models.hmm import StateMachineType
from cpecan_tpu.models.state_machine import state_machine5, state_machine3
from cpecan_tpu.ops import fb
from cpecan_tpu.ops.band import construct_band, full_band, pad_band
from cpecan_tpu.utils.symbols import encode, get_random_sequence, evolve_sequence

import oracle

import jax.numpy as jnp


def run_fb(sm, x, y, band=None, mode="posterior_match",
           ragged_left=False, ragged_right=False, W=None, P=None):
    lx, ly = len(x), len(y)
    band = band or full_band(lx, ly)
    W = W or band.frame_width()
    P = P or band.diagonal_number
    offsets, widths, L = pad_band(band, P)
    out = fb.fb_pass(
        sm.device_params(),
        jnp.asarray(encode(x), jnp.int32), jnp.asarray(encode(y), jnp.int32),
        jnp.asarray(offsets), jnp.asarray(widths),
        jnp.int32(lx), jnp.int32(ly),
        bool(ragged_left), bool(ragged_right), mode=mode, width=W)
    return {k: np.asarray(v) for k, v in out.items()}, band


def dense_posteriors(out, band, lx, ly, key="post_match"):
    """Scatter engine (diagonal, x-frame slot) posteriors into an
    (lx+1, ly+1) grid."""
    from cpecan_tpu.ops.pairs import frame_offsets

    post = np.zeros((lx + 1, ly + 1))
    pm = out[key]
    xoff = frame_offsets(band.offsets.astype(np.int64))
    for k in range(band.diagonal_number + 1):
        o, w = int(band.offsets[k]), int(band.widths[k])
        for j in range(w):
            x = (k + o + 2 * j) // 2
            y = k - x
            post[x, y] = pm[k, x - xoff[k]]
    return post


def log_forward_total(out, L):
    return float(out["log_fwd"]) + float(np.sum(out["mf"][: L + 1], dtype=np.float64))


class TestAgainstOracle:
    @pytest.mark.parametrize("sm_fn", [state_machine5, state_machine3])
    def test_agcg_agttcg_posteriors(self, sm_fn):
        """The reference oracle fixture (tests/pairwiseAlignerTest.c:242-324):
        full matrix of AGCG vs AGTTCG; fwd==bwd total and posterior pair set
        {(0,0),(1,1),(2,4),(3,5)} at threshold 0.2 for the 5-state machine."""
        sm = sm_fn()
        x, y = "AGCG", "AGTTCG"
        out, band = run_fb(sm, x, y)
        L = len(x) + len(y)

        post_o, total_o = oracle.posterior_match_probs(sm, x, y)
        total_e = log_forward_total(out, L)
        assert abs(total_e - total_o) < 1e-3

        post_e = dense_posteriors(out, band, len(x), len(y))
        np.testing.assert_allclose(post_e, post_o, atol=2e-3)

        if sm.state_number == 5:
            pairs = {(xi - 1, yi - 1)
                     for xi in range(1, 5) for yi in range(1, 7)
                     if post_e[xi, yi] >= 0.2}
            assert pairs == {(0, 0), (1, 1), (2, 4), (3, 5)}

    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("sm_fn", [state_machine5, state_machine3])
    def test_random_pairs_full_band(self, sm_fn, seed):
        import random
        rng = random.Random(seed)
        sm = sm_fn()
        x = get_random_sequence(rng.randint(5, 40), rng)
        y = evolve_sequence(x, rng)
        if not y:
            y = "A"
        out, band = run_fb(sm, x, y, mode="posterior_all")
        L = len(x) + len(y)

        post_o, total_o = oracle.posterior_match_probs(sm, x, y)
        assert abs(log_forward_total(out, L) - total_o) < 1e-2
        post_e = dense_posteriors(out, band, len(x), len(y))
        np.testing.assert_allclose(post_e, post_o, atol=5e-3)

    @pytest.mark.parametrize("ragged", [(True, False), (False, True), (True, True)])
    def test_ragged_ends(self, ragged):
        sm = state_machine5()
        x, y = "ACGTACGTAC", "TTACGTACGTACTT"
        out, band = run_fb(sm, x, y, ragged_left=ragged[0], ragged_right=ragged[1])
        L = len(x) + len(y)
        post_o, total_o = oracle.posterior_match_probs(
            sm, x, y, ragged_left=ragged[0], ragged_right=ragged[1])
        assert abs(log_forward_total(out, L) - total_o) < 1e-2
        post_e = dense_posteriors(out, band, len(x), len(y))
        np.testing.assert_allclose(post_e, post_o, atol=5e-3)

    def test_per_diagonal_totals_consistent(self):
        """The reference asserts every per-diagonal total equals the global
        total within 0.01 (tests/pairwiseAlignerTest.c:293-298)."""
        sm = state_machine5()
        x, y = "AGCG", "AGTTCG"
        out, band = run_fb(sm, x, y)
        L = len(x) + len(y)
        _, total_o = oracle.posterior_match_probs(sm, x, y)
        cf = np.cumsum(out["mf"][: L + 1], dtype=np.float64)
        cb = np.cumsum(out["mb"][: L + 1][::-1], dtype=np.float64)[::-1]
        for k in range(1, L + 1):
            total_k = out["total_raw"][k] + cf[k] + cb[k]
            assert abs(total_k - total_o) < 0.01, k

    def test_expectations_match_oracle(self):
        sm = state_machine5()
        x, y = "AGCGTT", "AGTTCG"
        out, band = run_fb(sm, x, y, mode="expectation")
        trans_o, emis_o, _ = oracle.expectations(sm, x, y)
        np.testing.assert_allclose(out["trans"], trans_o, atol=2e-3)
        np.testing.assert_allclose(out["emis"], emis_o, atol=2e-3)

    def test_expectations_3state(self):
        sm = state_machine3()
        x, y = "ACGTACGG", "ACTTACGG"
        out, band = run_fb(sm, x, y, mode="expectation")
        trans_o, emis_o, _ = oracle.expectations(sm, x, y)
        np.testing.assert_allclose(out["trans"], trans_o, atol=2e-3)
        np.testing.assert_allclose(out["emis"], emis_o, atol=2e-3)


class TestBanded:
    def test_banded_close_to_full(self):
        """A generous band around the main diagonal of two similar sequences
        reproduces the full-matrix posteriors."""
        import random
        rng = random.Random(7)
        sm = state_machine5()
        x = "ACGTGCATTTACGGCATGCA"
        y = "ACGTGCATTACGGCATGCAA"
        anchors = [(i, i) for i in range(4, 16, 4)]
        band = construct_band(anchors, len(x), len(y), 10)
        out, _ = run_fb(sm, x, y, band=band)
        post_o, total_o = oracle.posterior_match_probs(sm, x, y)
        post_e = dense_posteriors(out, band, len(x), len(y))
        # banded posterior at in-band cells should be close to unbanded
        for xi in range(1, len(x) + 1):
            for yi in range(1, len(y) + 1):
                if post_o[xi, yi] > 0.5:
                    assert abs(post_e[xi, yi] - post_o[xi, yi]) < 0.1

    def test_padding_invariance(self):
        """Padding diagonals/width must not change results."""
        sm = state_machine5()
        x, y = "ACGGT", "ACGT"
        out1, band = run_fb(sm, x, y)
        out2, _ = run_fb(sm, x, y, W=16, P=32)
        L = len(x) + len(y)
        np.testing.assert_allclose(
            log_forward_total(out1, L), log_forward_total(out2, L), atol=1e-4)
        p1 = dense_posteriors(out1, band, len(x), len(y))
        p2 = dense_posteriors(out2, band, len(x), len(y))
        np.testing.assert_allclose(p1, p2, atol=1e-5)


class TestDebugChecks:
    def test_debug_mode_passes_on_valid_input(self, monkeypatch):
        """CPECAN_TPU_DEBUG=1 runs the checkify-instrumented engine; on a
        healthy pair every device-side invariant holds and results match
        the plain engine exactly."""
        import random as _random

        from cpecan_tpu.models.state_machine import state_machine5
        from cpecan_tpu.ops import fb
        from cpecan_tpu.ops.band import full_band, pad_band
        from cpecan_tpu.utils.symbols import (encode, evolve_sequence,
                                              get_random_sequence)
        import jax.numpy as jnp

        rng = _random.Random(2)
        x = get_random_sequence(24, rng).upper()
        y = evolve_sequence(x, rng).upper() or "ACGT"
        P, W = 64, 32
        band = full_band(len(x), len(y))
        offsets, widths, L = pad_band(band, P, W)
        sx = np.zeros(P, np.int32)
        sy = np.zeros(P, np.int32)
        sx[:len(x)] = encode(x)
        sy[:len(y)] = encode(y)
        params = state_machine5().device_params()
        args = (params, jnp.asarray(sx), jnp.asarray(sy),
                jnp.asarray(offsets), jnp.asarray(widths),
                np.int32(len(x)), np.int32(len(y)), False, False)

        plain = fb.fb_pass(*args, mode="posterior_match", width=W)
        monkeypatch.setenv("CPECAN_TPU_DEBUG", "1")
        checked = fb.fb_pass(*args, mode="posterior_match", width=W)
        for k in plain:
            np.testing.assert_allclose(np.asarray(checked[k]),
                                       np.asarray(plain[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)

    def test_debug_mode_catches_corrupt_params(self, monkeypatch):
        """A deliberately broken model (NaN transition) trips the
        device-side invariants instead of silently emitting garbage."""
        import random as _random

        from jax.experimental import checkify

        from cpecan_tpu.models.state_machine import state_machine5
        from cpecan_tpu.ops import fb
        from cpecan_tpu.ops.band import full_band, pad_band
        from cpecan_tpu.utils.symbols import encode, get_random_sequence
        import jax.numpy as jnp

        rng = _random.Random(3)
        x = get_random_sequence(20, rng).upper()
        P, W = 64, 32
        band = full_band(len(x), len(x))
        offsets, widths, L = pad_band(band, P, W)
        sx = np.zeros(P, np.int32)
        sx[:len(x)] = encode(x)
        params = dict(state_machine5().device_params())
        params["t"] = jnp.asarray(params["t"]).at[1, 0, 0].set(jnp.nan)

        monkeypatch.setenv("CPECAN_TPU_DEBUG", "1")
        with pytest.raises(checkify.JaxRuntimeError, match="fb debug"):
            fb.fb_pass(params, jnp.asarray(sx), jnp.asarray(sx),
                       jnp.asarray(offsets), jnp.asarray(widths),
                       np.int32(len(x)), np.int32(len(x)), False, False,
                       mode="posterior_match", width=W)
