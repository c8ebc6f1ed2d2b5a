"""Checkpointed streaming FB vs the two-pass engine.

The streaming engine carries the exact backward state across windows, so
its posteriors/expectations must match fb_pass to fp tolerance for ANY
window size — including windows much smaller than the pair (the
memory-bounded regime for 1 Mb pairs, reference traceback windowing
impl/pairwiseAligner.c:792-861)."""

import random

import numpy as np
import pytest

from cpecan_tpu.align.anchors import get_anchors
from cpecan_tpu.config import PairwiseAlignmentParameters
from cpecan_tpu.models.state_machine import state_machine5
from cpecan_tpu.ops import fb, fb_streaming
from cpecan_tpu.ops.band import construct_band, full_band, pad_band
from cpecan_tpu.utils.symbols import encode, evolve_sequence, get_random_sequence

import jax.numpy as jnp


def _case(n=220, seed=5, expansion=8):
    rng = random.Random(seed)
    x = get_random_sequence(n, rng)
    y = evolve_sequence(x, rng)
    while len(y) < 4:
        y = evolve_sequence(x, rng)
    p = PairwiseAlignmentParameters(diagonalExpansion=expansion)
    anchors = [(a, b) for (a, b, *_r) in get_anchors(x, y, p)]
    band = construct_band(anchors, len(x), len(y), expansion)
    return x, y, band


def _two_pass(sm, x, y, band, mode, W):
    P = band.diagonal_number
    Pb = 1
    while Pb < P:
        Pb *= 2
    offsets, widths, L = pad_band(band, Pb)
    sx = np.zeros(Pb, np.int32)
    sy = np.zeros(Pb, np.int32)
    sx[: len(x)] = encode(x)
    sy[: len(y)] = encode(y)
    out = fb.fb_pass(sm.device_params(), jnp.asarray(sx), jnp.asarray(sy),
                     jnp.asarray(offsets), jnp.asarray(widths),
                     jnp.int32(len(x)), jnp.int32(len(y)), False, False,
                     mode=mode, width=W)
    return {k: np.asarray(v) for k, v in out.items()}, L


def _stream(sm, x, y, band, mode, W, window, threshold=0.0):
    return fb_streaming.fb_pass_streaming(
        sm.device_params(), encode(x), encode(y), band.offsets, band.widths,
        len(x), len(y), False, False, mode, W, window, threshold=threshold)


@pytest.mark.parametrize("window", [64, 128, 512])
def test_streaming_posteriors_match_two_pass(window):
    x, y, band = _case()
    sm = state_machine5()
    W = max(8, band.frame_width())
    ref, L = _two_pass(sm, x, y, band, "posterior_all", W)
    got = _stream(sm, x, y, band, "posterior_all", W, window)
    assert got["windows"] == -(-L // window)

    # per-diagonal scales and totals agree
    np.testing.assert_allclose(got["mf"][: L + 1], ref["mf"][: L + 1],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["mb"][1: L + 1], ref["mb"][1: L + 1],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["total_raw"][1: L + 1],
                               ref["total_raw"][1: L + 1],
                               rtol=1e-4, atol=1e-5)
    # log_fwd recombines to the same global likelihood
    lf_ref = ref["log_fwd"] + np.sum(ref["mf"][: L + 1], dtype=np.float64)
    lf_got = got["log_fwd"] + np.sum(got["mf"][: L + 1], dtype=np.float64)
    assert lf_got == pytest.approx(lf_ref, rel=1e-6, abs=1e-5)

    for key in ("post_match", "post_gap_x", "post_gap_y"):
        vals, ks, js = got["post_entries"][key]
        dense = np.zeros_like(ref[key])
        dense[ks, js] = vals
        np.testing.assert_allclose(dense[: L + 1], ref[key][: L + 1],
                                   rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("window", [64, 256])
def test_streaming_expectations_match_two_pass(window):
    x, y, band = _case(n=180, seed=9)
    sm = state_machine5()
    W = max(8, band.frame_width())
    ref, L = _two_pass(sm, x, y, band, "expectation", W)
    got = _stream(sm, x, y, band, "expectation", W, window)
    np.testing.assert_allclose(got["trans"], ref["trans"], rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(got["emis"], ref["emis"], rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(got["total_raw"][1: L + 1],
                               ref["total_raw"][1: L + 1],
                               rtol=1e-4, atol=1e-5)


def test_streaming_forward_mode():
    x, y, band = _case(n=150, seed=13)
    sm = state_machine5()
    W = max(8, band.frame_width())
    ref, L = _two_pass(sm, x, y, band, "forward", W)
    got = _stream(sm, x, y, band, "forward", W, 64)
    lf_ref = ref["log_fwd"] + np.sum(ref["mf"][: L + 1], dtype=np.float64)
    lf_got = got["log_fwd"] + np.sum(got["mf"][: L + 1], dtype=np.float64)
    assert lf_got == pytest.approx(lf_ref, rel=1e-6, abs=1e-5)


def test_streaming_full_band_unanchored():
    """Unanchored (full-band) short pair — exercises wide jlo/jhi travel."""
    rng = random.Random(3)
    x = get_random_sequence(60, rng)
    y = evolve_sequence(x, rng) or "ACGT"
    band = full_band(len(x), len(y))
    sm = state_machine5()
    W = max(8, band.frame_width())
    ref, L = _two_pass(sm, x, y, band, "posterior_match", W)
    got = _stream(sm, x, y, band, "posterior_match", W, 64)
    vals, ks, js = got["post_entries"]["post_match"]
    dense = np.zeros_like(ref["post_match"])
    dense[ks, js] = vals
    np.testing.assert_allclose(dense[: L + 1], ref["post_match"][: L + 1],
                               rtol=2e-4, atol=1e-6)


def test_batch_posteriors_stream_route_matches(monkeypatch):
    """Forcing the streaming route via a tiny budget must reproduce the
    bucketed two-pass batch results through the public API."""
    from cpecan_tpu.align import batch as batch_mod
    from cpecan_tpu.utils import metrics

    rng = random.Random(21)
    p = PairwiseAlignmentParameters(
        diagonalExpansion=6, minDiagsBetweenTraceBack=64,
        traceBackDiagonals=16)
    sm = state_machine5()
    jobs = []
    for i in range(3):
        x = get_random_sequence(rng.randint(80, 200), rng)
        y = evolve_sequence(x, rng) or "ACGT"
        anchors = get_anchors(x, y, p)
        jobs.append((x, y, anchors, False, False))

    ref = batch_mod.batch_posteriors(sm, jobs, p, mode="posterior_match")
    monkeypatch.setenv("CPECAN_TPU_STREAM_BUDGET", "1")  # stream everything
    got = batch_mod.batch_posteriors(sm, jobs, p, mode="posterior_match")
    monkeypatch.delenv("CPECAN_TPU_STREAM_BUDGET")
    for a, b in zip(got, ref):
        a = np.sort(a, order=["x", "y"])
        b = np.sort(b, order=["x", "y"])
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])
        np.testing.assert_allclose(a["prob"], b["prob"], rtol=2e-3, atol=30)


def test_expectation_step_stream_route_matches(monkeypatch):
    from cpecan_tpu.em import em as em_mod
    from cpecan_tpu.models.hmm import Hmm, StateMachineType
    from cpecan_tpu.io import cigar as cigar_io

    rng = random.Random(31)
    sequences = {}
    cigars = []
    for i in range(3):
        x = get_random_sequence(100, rng)
        y = evolve_sequence(x, rng) or "ACGTACGT"
        sequences[f"x{i}"] = x
        sequences[f"y{i}"] = y
        n = min(len(x), len(y))
        cigars.append(cigar_io.PairwiseAlignment(
            f"x{i}", 0, n, True, f"y{i}", 0, n, True, 0.0,
            [(cigar_io.MATCH, n)]))
    p = PairwiseAlignmentParameters(
        constraintDiagonalTrim=0, diagonalExpansion=6,
        minDiagsBetweenTraceBack=64, traceBackDiagonals=16)
    sm = state_machine5()
    tasks = em_mod.tasks_from_cigars(cigars, sequences, p)
    assert tasks

    serial = Hmm(StateMachineType.fiveState)
    em_mod.expectation_step(sm, tasks, p, serial)
    monkeypatch.setenv("CPECAN_TPU_STREAM_BUDGET", "1")
    streamed = Hmm(StateMachineType.fiveState)
    em_mod.expectation_step(sm, tasks, p, streamed)
    monkeypatch.delenv("CPECAN_TPU_STREAM_BUDGET")
    np.testing.assert_allclose(streamed.transitions, serial.transitions,
                               rtol=1e-4)
    np.testing.assert_allclose(streamed.emissions, serial.emissions,
                               rtol=1e-4)
    assert streamed.likelihood == pytest.approx(serial.likelihood, rel=1e-5)


def test_window_rows_honors_config():
    p = PairwiseAlignmentParameters()
    assert fb_streaming.window_rows(p) == -(-p.minDiagsBetweenTraceBack // 8) * 8
    p2 = PairwiseAlignmentParameters(minDiagsBetweenTraceBack=200,
                                     traceBackDiagonals=300)
    assert fb_streaming.window_rows(p2) >= 302


class _StubDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,expect", [
    ({"bytes_limit": 64 << 30, "bytes_in_use": 0}, 8 << 30),
    ({"bytes_limit": 60 << 30}, (60 << 30) // 8),
    ({"bytes_in_use": 5}, 1 << 30),
    (None, 1 << 30),
    ({"bytes_limit": 0}, 1 << 30),
])
def test_device_budget_from_stub_device(stats, expect):
    assert fb_streaming.device_budget_bytes(_StubDevice(stats)) == expect


@pytest.mark.parametrize("width", [41, 64])
def test_should_stream_pads_to_block_width(monkeypatch, width):
    """The streaming threshold counts the kernels' power-of-two block
    width (41 and 64 slots both hold 64), not a fixed lane padding."""
    rows = 10_000
    need = 3 * (rows + 1) * 5 * 64 * 4
    assert fb_streaming.resident_bytes(rows, width) == need
    monkeypatch.setenv("CPECAN_TPU_STREAM_BUDGET", str(need))
    assert not fb_streaming.should_stream(rows, width)
    monkeypatch.setenv("CPECAN_TPU_STREAM_BUDGET", str(need - 1))
    assert fb_streaming.should_stream(rows, width)
