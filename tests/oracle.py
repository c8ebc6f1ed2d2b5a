"""Naive full-matrix pair-HMM forward-backward oracle (float64 numpy).

Independent re-implementation of the DP semantics, cell by cell, used to
cross-check the banded FB engines — the same verification pattern the
reference uses (tests/pairwiseAlignerTest.c:242-324 builds an unbanded
matrix; :733-802 is a naive MEA reimplementation).
"""

from __future__ import annotations

import numpy as np

from cpecan_tpu.models.state_machine import StateMachine
from cpecan_tpu.utils.symbols import encode

NEG_INF = -np.inf


def _lse(values):
    finite = [v for v in values if v != NEG_INF]
    if not finite:
        return NEG_INF
    m = max(finite)
    return m + np.log(sum(np.exp(v - m) for v in values if v != NEG_INF))


def full_forward(sm: StateMachine, x: str, y: str, ragged_left=False):
    sx, sy = encode(x), encode(y)
    lx, ly = len(sx), len(sy)
    S = sm.state_number
    t_x, t_m, t_y = (np.asarray(a, np.float64) for a in (sm.t_x, sm.t_m, sm.t_y))
    em_m = np.asarray(sm.em_match, np.float64)
    eg_x = np.asarray(sm.em_gap_x, np.float64)
    eg_y = np.asarray(sm.em_gap_y, np.float64)
    start = np.asarray(sm.ragged_start if ragged_left else sm.start, np.float64)

    F = np.full((lx + 1, ly + 1, S), NEG_INF)
    F[0, 0] = start
    for k in range(1, lx + ly + 1):
        for xi in range(max(0, k - ly), min(k, lx) + 1):
            yi = k - xi
            for to in range(S):
                vals = []
                if xi >= 1:
                    e = eg_x[sx[xi - 1]]
                    vals += [F[xi - 1, yi, f] + t_x[f, to] + e for f in range(S)]
                if xi >= 1 and yi >= 1:
                    e = em_m[sx[xi - 1], sy[yi - 1]]
                    vals += [F[xi - 1, yi - 1, f] + t_m[f, to] + e for f in range(S)]
                if yi >= 1:
                    e = eg_y[sy[yi - 1]]
                    vals += [F[xi, yi - 1, f] + t_y[f, to] + e for f in range(S)]
                F[xi, yi, to] = _lse(vals)
    return F


def full_backward(sm: StateMachine, x: str, y: str, ragged_right=False):
    sx, sy = encode(x), encode(y)
    lx, ly = len(sx), len(sy)
    S = sm.state_number
    t_x, t_m, t_y = (np.asarray(a, np.float64) for a in (sm.t_x, sm.t_m, sm.t_y))
    em_m = np.asarray(sm.em_match, np.float64)
    eg_x = np.asarray(sm.em_gap_x, np.float64)
    eg_y = np.asarray(sm.em_gap_y, np.float64)
    end = np.asarray(sm.ragged_end if ragged_right else sm.end, np.float64)

    B = np.full((lx + 1, ly + 1, S), NEG_INF)
    B[lx, ly] = end
    for k in range(lx + ly - 1, -1, -1):
        for xi in range(max(0, k - ly), min(k, lx) + 1):
            yi = k - xi
            for f in range(S):
                vals = []
                if xi < lx:
                    e = eg_x[sx[xi]]
                    vals += [t_x[f, to] + e + B[xi + 1, yi, to] for to in range(S)]
                if xi < lx and yi < ly:
                    e = em_m[sx[xi], sy[yi]]
                    vals += [t_m[f, to] + e + B[xi + 1, yi + 1, to] for to in range(S)]
                if yi < ly:
                    e = eg_y[sy[yi]]
                    vals += [t_y[f, to] + e + B[xi, yi + 1, to] for to in range(S)]
                B[xi, yi, f] = _lse(vals)
    return B


def total_probability(sm: StateMachine, F, ragged_right=False):
    end = np.asarray(sm.ragged_end if ragged_right else sm.end, np.float64)
    return _lse(list(F[-1, -1] + end))


def posterior_match_probs(sm: StateMachine, x: str, y: str,
                          ragged_left=False, ragged_right=False):
    """Dense (lx+1, ly+1) matrix of match posteriors (0 at x==0 or y==0)."""
    F = full_forward(sm, x, y, ragged_left)
    B = full_backward(sm, x, y, ragged_right)
    total = total_probability(sm, F, ragged_right)
    post = np.exp(F[:, :, 0] + B[:, :, 0] - total)
    post[0, :] = 0.0
    post[:, 0] = 0.0
    return post, total


def expectations(sm: StateMachine, x: str, y: str,
                 ragged_left=False, ragged_right=False):
    """Expected transition/emission counts, naive cell-by-cell
    (updateExpectations semantics, reference impl/pairwiseAligner.c:418-438).
    Returns (trans (S,S), emis (S,4,4), total)."""
    sx, sy = encode(x), encode(y)
    lx, ly = len(sx), len(sy)
    S = sm.state_number
    t_x, t_m, t_y = (np.asarray(a, np.float64) for a in (sm.t_x, sm.t_m, sm.t_y))
    em_m = np.asarray(sm.em_match, np.float64)
    eg_x = np.asarray(sm.em_gap_x, np.float64)
    eg_y = np.asarray(sm.em_gap_y, np.float64)

    F = full_forward(sm, x, y, ragged_left)
    B = full_backward(sm, x, y, ragged_right)
    total = total_probability(sm, F, ragged_right)

    trans = np.zeros((S, S))
    emis = np.zeros((S, 4, 4))

    def add(xi, yi, f, to, e, t):
        if t == NEG_INF:
            return
        p = np.exp(F_prev + e + t + B[xi, yi, to] - total)
        trans[f, to] += p
        cx = sx[xi - 1] if xi >= 1 else 4
        cy = sy[yi - 1] if yi >= 1 else 4
        if cx < 4 and cy < 4:
            emis[to, cx, cy] += p

    for xi in range(lx + 1):
        for yi in range(ly + 1):
            for f in range(S):
                for to in range(S):
                    if xi >= 1:
                        F_prev = F[xi - 1, yi, f]
                        add(xi, yi, f, to, eg_x[sx[xi - 1]], t_x[f, to])
                    if xi >= 1 and yi >= 1:
                        F_prev = F[xi - 1, yi - 1, f]
                        add(xi, yi, f, to, em_m[sx[xi - 1], sy[yi - 1]], t_m[f, to])
                    if yi >= 1:
                        F_prev = F[xi, yi - 1, f]
                        add(xi, yi, f, to, eg_y[sy[yi - 1]], t_y[f, to])
    return trans, emis, total
