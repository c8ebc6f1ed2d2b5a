"""Banded pair-HMM forward-backward on anti-diagonal wavefronts.

A re-design of the reference banded FB engine for accelerators
(impl/pairwiseAligner.c:756-949). Design (see SURVEY.md section 7):

 * **Scaled-probability space.** The reference computes in log space with
   an approximate lookup logAdd (:287-307); log-space cell updates are
   transcendental-bound. Here every diagonal is stored as probabilities
   normalized by the diagonal max (the classic scaled pair-HMM
   formulation): the cell update is one small matrix contraction — pure
   multiply-add — and one scalar log per diagonal records the scale
   (mf/mb). Cells more than ~87 nats below the per-diagonal max flush to
   zero in fp32; those posteriors are < 1e-30. Global log-likelihoods
   recombine the per-diagonal scale logs in float64 on the host.

 * **x-frame sliding window.** Band cells are indexed by x: slot j of
   diagonal k holds the cell with x = xoff[k] + j, where xoff = cummax of
   the band's left x edge. x changes by at most 1 per diagonal, so xoff
   advances by delta in {0,1} per step and every neighbor access is a
   2-3 way select between *static* shifts — no data-dependent gathers in
   the hot loop.

 * **Lean scans, vectorized reductions.** The sequential scans compute
   only the forward/backward value recursions and emit all diagonals
   (F_all/B_all). Per-diagonal totals (forward.backward dot plus the match
   "bridge" correction — semantics of diagonalCalculationTotalProbability
   :636-653), posteriors and EM expectation counts are computed afterwards
   as big batched einsums over the whole (P, S, W) tensors — no scan
   overhead on them. Normalizing every diagonal by its own exact total
   also makes posteriors immune to scale drift (the reference re-estimates
   the total every 10 diagonals for the same reason, :830-838).

Cell/neighbor geometry (reference :609-624): cell (xay=k, xmy) has
  lower  = (k-1, xmy-1)  consuming X  (gap-X transitions)   x' = x-1
  middle = (k-2, xmy)    consuming XY (match transitions)   x' = x-1
  upper  = (k-1, xmy+1)  consuming Y  (gap-Y transitions)   x' = x
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Sentinel symbol for out-of-sequence positions: its one-hot row over
# arange(5) is all-zero, so any emission probability computed from it is 0.
_SENTINEL = 5

_UNROLL = 4

# Apply the per-row max-rescale only every NORM_EVERY diagonals (global
# index k % NORM_EVERY == NORM_EVERY - 1); fp32 absorbs the scale drift in
# between. The GPU kernels (ops/fb_wavefront.py) follow the same schedule,
# so the engines' F/mf streams stay elementwise comparable.
NORM_EVERY = 4


def _shift_right(arr, fill=0.0):
    """out[..., j] = arr[..., j-1]."""
    return jnp.concatenate(
        [jnp.full_like(arr[..., :1], fill), arr[..., :-1]], axis=-1)


def _shift_left(arr, fill=0.0):
    """out[..., j] = arr[..., j+1]."""
    return jnp.concatenate(
        [arr[..., 1:], jnp.full_like(arr[..., :1], fill)], axis=-1)


def _select_shift(arr, amount):
    """out[..., j] = arr[..., j + amount] for amount in {-1, 0, +1}; the
    amount may be a traced scalar or an array broadcastable against arr's
    leading axes. Out-of-range reads 0."""
    amount = jnp.asarray(amount)
    shape = amount.shape + (1,) * (arr.ndim - amount.ndim)
    amount = amount.reshape(shape)
    return jnp.where(
        amount == 0, arr,
        jnp.where(amount == 1, _shift_left(arr), _shift_right(arr)))


def _symbol_windows_scan(sx_pad, sy_pad, xoff, delta, LY, W, ks=None,
                         pad_off=None):
    """Per-diagonal symbol windows via a feather-weight int8 scan.

    Exploits the monotone x-frame: the x-window start advances by
    delta in {0,1} per diagonal and the (reversed) y-window start
    retreats by delta-1 — so each row is the previous row shifted by a
    constant with one new element appended/prepended. The only gathers
    are the per-diagonal single elements (P+1 each), everything else is
    selects.

    ks: absolute diagonal indices of the rows (default arange) — lets the
    streaming engine compute windows for an interior diagonal range.
    pad_off: the sentinel padding length actually prepended to
    sx_pad/sy_pad (default W+1) — pass it when the arrays were padded
    for a different window width.

    Returns (wx, wy), each (P+1, W+1) int8:
      wx[k, j]   = sx_pad[xoff[k] - 1 + j + pad]   (x-1 at j, x at j+1)
      wy[k, j]   = sy_pad[LY - k + xoff[k] - 1 + j + pad]  (y at j, y-1 at j+1)
    """
    P = xoff.shape[0] - 1
    if pad_off is None:
        pad_off = W + 1
    if ks is None:
        ks = jnp.arange(P + 1, dtype=jnp.int32)
    row_x0 = jax.lax.dynamic_slice(sx_pad, (xoff[0] - 1 + pad_off,), (W + 1,))
    row_y0 = jax.lax.dynamic_slice(
        sy_pad, (LY - ks[0] + xoff[0] - 1 + pad_off,), (W + 1,))

    # per-diagonal single-element gathers (tiny); the row's last element
    # sits at sequence index xoff[k] + W - 1
    next_x = sx_pad[jnp.clip(xoff + W - 1 + pad_off, 0, sx_pad.shape[0] - 1)]
    first_y = sy_pad[jnp.clip(LY - ks + xoff - 1 + pad_off, 0, sy_pad.shape[0] - 1)]

    def step(carry, inputs):
        rx, ry = carry
        d_k, nx_k, fy_k = inputs
        rx_new = jnp.where(d_k == 1,
                           jnp.concatenate([rx[1:], nx_k[None]]), rx)
        ry_new = jnp.where(d_k == 1, ry,
                           jnp.concatenate([fy_k[None], ry[:-1]]))
        return (rx_new, ry_new), (rx_new, ry_new)

    inputs = (delta[1:], next_x[1:], first_y[1:])
    _, (wx_rest, wy_rest) = jax.lax.scan(step, (row_x0, row_y0), inputs,
                                         unroll=_UNROLL)
    wx = jnp.concatenate([row_x0[None], wx_rest], axis=0)
    wy = jnp.concatenate([row_y0[None], wy_rest], axis=0)
    return wx, wy


def _prob_params(params):
    """Log-space StateMachine params -> probability space."""
    return {
        "t": jnp.exp(params["t"]),  # (3, S, S)
        "em_match": jnp.exp(params["em_match"]),  # (5, 5)
        "em_gap_x": jnp.exp(params["em_gap_x"]),  # (5,)
        "em_gap_y": jnp.exp(params["em_gap_y"]),
        "start": jnp.exp(params["start"]),
        "ragged_start": jnp.exp(params["ragged_start"]),
        "end": jnp.exp(params["end"]),
        "ragged_end": jnp.exp(params["ragged_end"]),
    }


def _frame_from_band(offsets, widths):
    """x-frame tensors from (offsets, widths) band tensors: xoff (window
    start), delta = xoff step in {0,1}, jlo/jhi slot bounds."""
    P = offsets.shape[0] - 1
    ks = jnp.arange(P + 1, dtype=jnp.int32)
    xlo = (ks + offsets) // 2
    xhi = xlo + widths - 1
    xoff = jax.lax.cummax(xlo)
    delta = jnp.diff(xoff, prepend=xoff[:1])
    jlo = xlo - xoff
    jhi = xhi - xoff
    return xoff, delta, jlo, jhi


def _one_hot(sym, n=5):
    """(..., W) int symbols -> (..., W, n) float32 one-hot; sentinel rows
    are all-zero."""
    return (sym[..., None] == jnp.arange(n, dtype=sym.dtype)).astype(jnp.float32)


def _lookup1(sym, table5):
    """Elementwise 5-entry table lookup via a fused select chain (exact
    f32). Sentinel symbols map to 0."""
    out = jnp.zeros(sym.shape, jnp.float32)
    for i in range(5):
        out = jnp.where(sym == i, table5[i], out)
    return out


def _lookup2(symx, symy, table55):
    """Elementwise 5x5 table lookup via nested select chains. Any sentinel
    symbol maps to 0."""
    out = jnp.zeros(symx.shape, jnp.float32)
    for a in range(5):
        row = jnp.zeros(symy.shape, jnp.float32)
        for b in range(5):
            row = jnp.where(symy == b, table55[a, b], row)
        out = jnp.where(symx == a, row, out)
    return out


def _emissions(prob, wsymx, wsymy):
    """Per-slot emission probabilities for symbol windows: returns
    (e_x, e_y, e_m) each with the windows' shape."""
    e_x = _lookup1(wsymx, prob["em_gap_x"])
    e_y = _lookup1(wsymy, prob["em_gap_y"])
    e_m = _lookup2(wsymx, wsymy, prob["em_match"])
    return e_x, e_y, e_m


def _fwd_step(prob, width):
    """Forward scan step over (F_{k-1}, F_{k-2}, 1/m_{k-1}) carries; inputs
    are (do_norm_k, d_k, d_{k-1}, jlo_k, jhi_k, ex_k, ey_k, em_k).

    do_norm_k: apply the max-rescale on this row (mf_k = 0 on skipped
    rows).  The schedule is norm_flags() of the global diagonal index."""
    S = prob["start"].shape[0]
    t_cat = prob["t"].reshape(3 * S, S)  # [x; m; y]
    js = jnp.arange(width, dtype=jnp.int32)

    def step(carry, inputs):
        F1, F2, inv_m1 = carry
        do_norm, d_k, d_km1, jlo_k, jhi_k, ex_k, ey_k, em_k = inputs

        # lower (x-1 @ k-1): shift d_k - 1; upper (x @ k-1): d_k;
        # middle (x-1 @ k-2): d_k + d_km1 - 1  (all in {-1, 0, 1})
        lower = _select_shift(F1, d_k - 1) * ex_k[None, :]
        upper = _select_shift(F1, d_k) * ey_k[None, :]
        middle = _select_shift(F2, d_k + d_km1 - 1) * (inv_m1 * em_k)[None, :]

        stacked = jnp.concatenate([lower, middle, upper], axis=0)  # (3S, W)
        cur = jnp.einsum("Fj,Ft->tj", stacked, t_cat, precision=jax.lax.Precision.HIGHEST)
        cur = cur * ((js >= jlo_k) & (js <= jhi_k))[None, :]

        m = jnp.max(cur)
        m = jnp.where(do_norm & (m > 0), m, 1.0)
        F_new = cur / m
        return (F_new, F1, 1.0 / m), (F_new, jnp.log(m))

    return step


def initial_forward_carry(prob, ragged_left, width):
    """(F0, 0, 1) carry for diagonal 0, plus log m0."""
    S = prob["start"].shape[0]
    start_vec = jnp.where(ragged_left, prob["ragged_start"], prob["start"])
    F0 = jnp.zeros((S, width), jnp.float32).at[:, 0].set(start_vec)
    m0 = jnp.max(F0)
    m0 = jnp.where(m0 > 0, m0, 1.0)
    F0 = F0 / m0
    carry = (F0, jnp.zeros((S, width), jnp.float32), jnp.float32(1.0))
    return carry, jnp.log(m0)


def norm_flags(ks):
    """Per-row max-rescale schedule from global diagonal indices: norm
    iff k % NORM_EVERY == NORM_EVERY - 1."""
    return (ks % NORM_EVERY) == (NORM_EVERY - 1)


def forward_window(prob, e_x, e_y, e_m, delta, d_km1, jlo, jhi, carry, width,
                   ks):
    """Forward recursion over an interior row range [k0, k0+K) from an
    explicit carry (F_{k0-1}, F_{k0-2}, 1/m_{k0-1}). All stream args are
    (K, ...) per-row; d_km1 is delta shifted by one row; ks are the
    absolute diagonal indices (for the normalization schedule).
    Returns (carry_out, F_win [K,S,W], mf_win [K])."""
    step = _fwd_step(prob, width)
    carry_out, (F_win, mf_win) = jax.lax.scan(
        step, carry,
        (norm_flags(ks), delta, d_km1, jlo, jhi, e_x, e_y, e_m),
        unroll=_UNROLL)
    return carry_out, F_win, mf_win


def forward_sweep(prob, e_x, e_y, e_m, delta, jlo, jhi, ragged_left, width):
    """Forward recursion in scaled-prob space.

    e_* are (P+1, W) per-diagonal emission rows (for the cell's own
    consumed symbols, x-1 / y-1 indexed).
    Returns (F_all [P+1,S,W] per-diagonal-normalized forward probs,
    mf [P+1] log scales). True logF_k = log(F_all[k]) + sum(mf[:k+1]).
    """
    init, m0log = initial_forward_carry(prob, ragged_left, width)
    P = delta.shape[0] - 1
    ks = jnp.arange(1, P + 1, dtype=jnp.int32)
    _, F_rest, mf_rest = forward_window(
        prob, e_x[1:], e_y[1:], e_m[1:], delta[1:], delta[:-1],
        jlo[1:], jhi[1:], init, width, ks)
    F_all = jnp.concatenate([init[0][None], F_rest], axis=0)
    mf = jnp.concatenate([m0log[None], mf_rest])
    return F_all, mf


def _bwd_step(prob, L, end_vec, width):
    """Backward scan step over (B_{k+1}, B_{k+2}, 1/mb_{k+1}) carries;
    inputs are (k, d_{k+1}, d_{k+2}, jlo_k, jhi_k, efx_k, efy_k, efm_k)."""
    # backward stacked transitions: contribution[f,j] = sum_c,t T_c[f,t]*n_c[t,j]
    t_cat_b = jnp.concatenate([prob["t"][0], prob["t"][1], prob["t"][2]], axis=1)  # (S, 3S)
    js = jnp.arange(width, dtype=jnp.int32)

    def step(carry, inputs):
        B1, B2, inv_mb1 = carry
        k, d_k1, d_k2, jlo_k, jhi_k, efx_k, efy_k, efm_k = inputs
        do_norm = norm_flags(k)
        slot_ok = (js >= jlo_k) & (js <= jhi_k)

        # receive from k+1: x-class at j+1-d_k1, y-class at j-d_k1;
        # from k+2: m-class at j+1-d_k1-d_k2. Emissions are functions of
        # the CURRENT cell, so multiply after shifting.
        bx = _select_shift(B1, 1 - d_k1) * efx_k[None, :]
        by = _select_shift(B1, -d_k1) * efy_k[None, :]
        bm = _select_shift(B2, 1 - d_k1 - d_k2) * (inv_mb1 * efm_k)[None, :]

        stacked = jnp.concatenate([bx, bm, by], axis=0)  # (3S, W)
        raw = jnp.einsum("tj,ft->fj", stacked, t_cat_b, precision=jax.lax.Precision.HIGHEST)
        raw = raw * slot_ok[None, :]

        at_end = k == L
        raw = jnp.where(at_end, end_vec[:, None] * slot_ok[None, :], raw)

        m = jnp.max(raw)
        m = jnp.where(do_norm & (m > 0) & ~at_end, m, 1.0)
        B_k = raw / m
        B2_next = jnp.where(at_end, jnp.zeros_like(B1), B1)
        inv_next = jnp.where(at_end, 1.0, 1.0 / m)
        return (B_k, B2_next, inv_next), (B_k, jnp.log(m))

    return step


def backward_window(prob, ef_x, ef_y, ef_m, ks, d_k1, d_k2, jlo, jhi,
                    L, end_vec, carry, width):
    """Backward recursion over an interior row range, processed high-to-low
    from an explicit carry (B_{k1}, B_{k1+1}, 1/mb_{k1}). Stream args are
    (K, ...) in ROW order (low-to-high); ks are the absolute diagonal
    indices; d_k1/d_k2 are delta at rows k+1 / k+2.
    Returns (carry_out, B_win [K,S,W] row order, mb_win [K])."""
    step = _bwd_step(prob, L, end_vec, width)
    rev = lambda a: jnp.flip(a, axis=0)
    inputs = tuple(rev(a) for a in (ks, d_k1, d_k2, jlo, jhi, ef_x, ef_y, ef_m))
    carry_out, (B_rev, mb_rev) = jax.lax.scan(step, carry, inputs,
                                              unroll=_UNROLL)
    return carry_out, jnp.flip(B_rev, axis=0), jnp.flip(mb_rev, axis=0)


def backward_sweep(prob, ef_x, ef_y, ef_m, delta, jlo, jhi, L, end_vec, width):
    """Backward recursion in scaled-prob space.

    ef_* are (P+1, W) future-cell emission rows (x / y indexed: the
    emissions consumed moving OUT of each cell).
    Returns (B_all [P+1,S,W], mb [P+1] log scales).
    True logB_k = log(B_all[k]) + sum(mb[k:L+1]).
    """
    S = end_vec.shape[0]
    P = delta.shape[0] - 1
    W = width
    delta_pad = jnp.concatenate([delta, jnp.zeros((2,), delta.dtype)])
    ks = jnp.arange(P + 1, dtype=jnp.int32)
    init = (jnp.zeros((S, W), jnp.float32), jnp.zeros((S, W), jnp.float32),
            jnp.float32(1.0))
    _, B_all, mb = backward_window(
        prob, ef_x, ef_y, ef_m, ks, delta_pad[1:P + 2], delta_pad[2:P + 3],
        jlo, jhi, L, end_vec, init, W)
    return B_all, mb


def _fb_pass_impl(params, sx, sy, offsets, widths, lx, ly,
                  ragged_left, ragged_right, mode: str = "posterior_match",
                  width: int = 0, debug: bool = False):
    """Full banded forward-backward pass for one (padded) pair.

    Args:
      params: StateMachine.device_params() pytree (log space).
      sx, sy: int padded symbol arrays.
      offsets, widths: int32 (P+1,) padded band tensors (pad_band).
      lx, ly: true sequence lengths (traced scalars). L = lx + ly.
      ragged_left/right: bool scalars selecting ragged start/end dists
        (reference getPosteriorProbsWithBanding args :756-758).
      mode: "posterior_match" | "posterior_all" | "expectation" | "forward".
      width: static slot-window size; must be >= BandTensors.frame_width().

    Returns a dict:
      always: "mf","mb" (P+1,) per-diagonal log scales; "log_fwd" raw end
        dot at L (true forward log-prob = log_fwd + sum(mf[:L+1]), host f64)
      posterior modes: "post_match" (P+1, W) posterior probs (0 outside
        band/valid), slot j of diagonal k = cell x = xoff[k] + j;
        posterior_all adds "post_gap_x","post_gap_y"
      expectation: "trans" (S,S), "emis" (S,4,4) expected counts and
        "total_raw" (P+1,) per-diagonal raw log totals for the likelihood.
    """
    S = params["start"].shape[0]
    P = offsets.shape[0] - 1
    W = width
    L = lx + ly
    prob = _prob_params(params)

    xoff, delta, jlo, jhi = _frame_from_band(offsets, widths)

    # Symbol windows (one batched slice-gather each; sentinel-padded).
    LX = sx.shape[0]
    LY = sy.shape[0]
    sx_s = jnp.where(jnp.arange(LX) < lx, sx, _SENTINEL).astype(jnp.int8)
    sy_s = jnp.where(jnp.arange(LY) < ly, sy, _SENTINEL).astype(jnp.int8)
    sy_rev = jnp.flip(sy_s)  # sy_rev[i] = sy[LY-1-i]
    pad = jnp.full((W + 1,), _SENTINEL, jnp.int8)
    sx_pad = jnp.concatenate([pad, sx_s, pad])
    sy_pad = jnp.concatenate([pad, sy_rev, pad])
    # (P+1, W+1) sliding windows; own-cell symbols (x-1 / y-1) and
    # future-cell symbols (x / y) are static column views of the same rows
    wx, wy = _symbol_windows_scan(sx_pad, sy_pad, xoff, delta, LY, W)
    wsymx = wx[:, :W]
    wsymx_f = wx[:, 1:]
    wsymy_f = wy[:, :W]
    wsymy = wy[:, 1:]

    e_x, e_y, e_m = _emissions(prob, wsymx, wsymy)
    F_all, mf = forward_sweep(prob, e_x, e_y, e_m, delta, jlo, jhi,
                              ragged_left, W)

    end_vec = jnp.where(ragged_right, prob["ragged_end"], prob["end"])
    fe = jnp.log(jnp.einsum("ksj,s->k", F_all, end_vec, precision=jax.lax.Precision.HIGHEST))
    log_fwd = fe[jnp.clip(L, 0, P)]

    out = {"mf": mf, "log_fwd": log_fwd}
    if mode == "forward":
        out["mb"] = jnp.zeros_like(mf)
        return out

    ef_x, ef_y, ef_m = _emissions(prob, wsymx_f, wsymy_f)
    B_all, mb = backward_sweep(prob, ef_x, ef_y, ef_m, delta, jlo, jhi,
                               L, end_vec, W)
    out["mb"] = mb

    # ---- vectorized per-diagonal totals: dot + match bridge ----
    dot = jnp.einsum("ksj,ksj->k", F_all, B_all, precision=jax.lax.Precision.HIGHEST)

    # bridge_k: paths crossing k via one match from k-1 to k+1, evaluated
    # on the (k+1) cells: middle neighbor of (k+1, j') is slot
    # j' + d_{k+1} + d_k - 1 of F_{k-1}; emission is the (k+1) cell's own
    # match emission e_m[k+1]. Vectorized per row r = k+1: F_{r-2} shifted
    # by d_r + d_{r-1} - 1, paired with B_all[r].
    zero_row = jnp.zeros((1, S, W), F_all.dtype)
    F_rm2 = jnp.concatenate([zero_row, zero_row, F_all[:-2]])
    d_sum = delta + jnp.concatenate([delta[:1], delta[:-1]])  # d_r + d_{r-1}
    mid = _select_shift(F_rm2, d_sum - 1)
    t_m = prob["t"][1]
    Mext = jnp.einsum("kfj,ft->ktj", mid, t_m, precision=jax.lax.Precision.HIGHEST) * e_m[:, None, :]
    bridge_at = jnp.einsum("ktj,ktj->k", Mext, B_all, precision=jax.lax.Precision.HIGHEST)  # value at row r
    # bridge_at[k+1] pairs F_{k-1}(+cf_{k-1}) with B_{k+1}(+cb_{k+1});
    # express in the (cf_k + cb_k) frame of diagonal k:
    bridge = jnp.concatenate([bridge_at[1:], jnp.zeros((1,), bridge_at.dtype)])
    scale_adj = jnp.exp(-mf - mb)
    ks_f = jnp.arange(P + 1, dtype=jnp.int32)
    bridge = jnp.where((ks_f >= 1) & (ks_f < L), bridge * scale_adj, 0.0)
    total = dot + bridge
    out["total_raw"] = jnp.log(total)

    valid_k = (ks_f >= 1) & (ks_f <= L)

    if debug:
        # Device-side invariants (jax.experimental.checkify user checks),
        # the analog of the reference's pervasive asserts: the C re-checks
        # the total-prob estimate every 10 posterior diagonals and aborts
        # when successive estimates drift (impl/pairwiseAligner.c:830-838).
        # Here every diagonal's total, rescaled to the global frame
        # (total_raw[k] + cumsum(mf)[k] + revcumsum(mb)[k]), must agree.
        from jax.experimental import checkify

        cf = jnp.cumsum(mf)
        cb = jnp.flip(jnp.cumsum(jnp.flip(mb)))
        g = out["total_raw"] + cf + cb
        mask = (ks_f >= 1) & (ks_f <= L)
        ref_tot = jnp.max(jnp.where(mask, g, -jnp.inf))
        drift = jnp.where(mask, ref_tot - g, 0.0)
        checkify.check(
            jnp.all(jnp.isfinite(jnp.where(mask, g, 0.0))),
            "fb debug: non-finite per-diagonal total")
        checkify.check(jnp.max(drift) < 1.0,
                       "fb debug: per-diagonal totals drift > 1 nat "
                       "(forward/backward inconsistency)")
        checkify.check(
            jnp.all(jnp.isfinite(jnp.where(mask, mf + mb, 0.0))),
            "fb debug: non-finite diagonal scale")
    js = jnp.arange(W, dtype=jnp.int32)
    xs = xoff[:, None] + js[None, :]
    ys = ks_f[:, None] - xs
    slot_ok = (js[None, :] >= jlo[:, None]) & (js[None, :] <= jhi[:, None])

    if mode in ("posterior_match", "posterior_all"):
        inv_total = jnp.where(total > 0, 1.0 / total, 0.0)

        def posterior(state, coord_ok):
            p = F_all[:, state, :] * B_all[:, state, :] * inv_total[:, None]
            return jnp.where(valid_k[:, None] & slot_ok & coord_ok, p, 0.0)

        out["post_match"] = posterior(0, (xs > 0) & (ys > 0))
        if mode == "posterior_all":
            out["post_gap_x"] = posterior(1, xs > 0)
            out["post_gap_y"] = posterior(2, ys > 0)
        if debug:
            from jax.experimental import checkify

            checkify.check(jnp.max(out["post_match"]) <= 1.0 + 1e-3,
                           "fb debug: match posterior > 1")

    if mode == "expectation":
        out["trans"], out["emis"] = _expectations(
            prob, F_all, B_all, mf, total, delta, e_x, e_y, e_m,
            wsymx, wsymy, slot_ok, valid_k)
    return out


_fb_pass_jit = functools.partial(
    jax.jit, static_argnames=("mode", "width", "debug"))(_fb_pass_impl)

_checked_cache: dict = {}


def debug_checks_enabled() -> bool:
    """CPECAN_TPU_DEBUG=1 turns on device-side checkify invariants (the
    reference's pervasive asserts — e.g. the monotone total-prob check,
    impl/pairwiseAligner.c:833-836 — as jax.experimental.checkify user
    checks)."""
    import os

    return os.environ.get("CPECAN_TPU_DEBUG", "0") != "0"


def fb_pass(params, sx, sy, offsets, widths, lx, ly,
            ragged_left, ragged_right, mode: str = "posterior_match",
            width: int = 0):
    """Banded FB pass for one padded pair (see _fb_pass_impl for the
    contract). Dispatch: the plain jitted engine, or — with
    CPECAN_TPU_DEBUG=1 and a direct (untraced) call — a
    checkify-transformed variant that raises on violated device-side
    invariants (per-diagonal total drift, non-finite scales,
    posterior > 1)."""
    if debug_checks_enabled() and not isinstance(lx, jax.core.Tracer):
        from jax.experimental import checkify

        key = (mode, width)
        fn = _checked_cache.get(key)
        if fn is None:
            fn = jax.jit(checkify.checkify(
                functools.partial(_fb_pass_impl, mode=mode, width=width,
                                  debug=True),
                errors=checkify.user_checks))
            _checked_cache[key] = fn
        err, out = fn(params, sx, sy, offsets, widths, lx, ly,
                      ragged_left, ragged_right)
        checkify.check_error(err)
        return out
    return _fb_pass_jit(params, sx, sy, offsets, widths, lx, ly,
                        ragged_left, ragged_right, mode=mode, width=width)


def _expectations(prob, F_all, B_all, mf, total, delta, e_x, e_y, e_m,
                  wsymx, wsymy, slot_ok, valid_k, halo=None):
    """Vectorized posterior transition/emission expected counts over all
    diagonals (semantics of diagonalCalculationExpectations /
    updateExpectations, reference impl/pairwiseAligner.c:735-746, :418-438):
      p = F_prev[from] * T_c * e_c * B_k[to] / total_k;
      trans[from,to] += p; emis[to,symx,symy] += p (N symbols excluded).

    Scaled space: relative to diagonal k's frame, F_{k-1} carries an extra
    exp(-mf_k) and F_{k-2} an extra exp(-mf_k - mf_{k-1}).

    halo: optional (F1c, F2c, mf_boundary, d_boundary) giving the true
    F_{k0-1}, F_{k0-2}, mf_{k0-1}, delta_{k0-1} when F_all is an interior
    window [k0, k0+K) of the streaming engine (default: row 0 boundary,
    where the F_{-1}/F_{-2} neighbors are zero).
    """
    S = F_all.shape[1]
    W = F_all.shape[2]
    t_x, t_m, t_y = prob["t"][0], prob["t"][1], prob["t"][2]

    zero = jnp.zeros((1, S, W), F_all.dtype)
    if halo is None:
        F_km1 = jnp.concatenate([zero, F_all[:-1]])
        F_km2 = jnp.concatenate([zero, zero, F_all[:-2]])
        mf_km1 = jnp.concatenate([jnp.zeros((1,), mf.dtype), mf[:-1]])
        d_km1 = jnp.concatenate([delta[:1], delta[:-1]])
    else:
        F1c, F2c, mf_b, d_b = halo
        F_km1 = jnp.concatenate([F1c[None], F_all[:-1]])
        F_km2 = jnp.concatenate([F2c[None], F1c[None], F_all[:-2]])
        mf_km1 = jnp.concatenate([mf_b[None].astype(mf.dtype), mf[:-1]])
        d_km1 = jnp.concatenate([d_b[None].astype(delta.dtype), delta[:-1]])

    adj1 = jnp.exp(-mf)
    adj2 = jnp.exp(-mf - mf_km1)
    lower = _select_shift(F_km1, delta - 1) * adj1[:, None, None]
    upper = _select_shift(F_km1, delta) * adj1[:, None, None]
    middle = _select_shift(F_km2, delta + d_km1 - 1) * adj2[:, None, None]

    inv_total = jnp.where(valid_k & (total > 0), 1.0 / total, 0.0)
    mask = slot_ok.astype(jnp.float32) * inv_total[:, None]  # (P+1, W)

    def class_counts(neighbor, t_c, e_c):
        rhs = B_all * (e_c * mask)[:, None, :]  # (P+1, S, W)
        m = jnp.einsum("kfj,ktj->ft", neighbor, rhs, precision=jax.lax.Precision.HIGHEST)
        q = jnp.einsum("kfj,ft->ktj", neighbor, t_c, precision=jax.lax.Precision.HIGHEST) * rhs
        return t_c * m, q

    px, qx = class_counts(lower, t_x, e_x)
    pm, qm = class_counts(middle, t_m, e_m)
    py, qy = class_counts(upper, t_y, e_y)
    trans = px + pm + py

    q = qx + qm + qy  # (P+1, to, j) posterior flow into `to` at each cell
    ar = jnp.arange(4, dtype=wsymx.dtype)
    ohx = (wsymx[..., None] == ar).astype(jnp.float32)  # N/sentinel -> zero
    ohy = (wsymy[..., None] == ar).astype(jnp.float32)
    emis = jnp.einsum("ktj,kja,kjb->tab", q, ohx, ohy, precision=jax.lax.Precision.HIGHEST)
    return trans, emis
