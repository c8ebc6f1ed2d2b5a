"""Checkpointed streaming forward-backward for long pairs.

Bounds live memory to O(band * window) for arbitrarily long banded
pairs — a re-design of the reference's traceback-window
machinery (getPosteriorProbsWithBanding, impl/pairwiseAligner.c:756-877,
window logic :792-861), honoring `minDiagsBetweenTraceBack` /
`traceBackDiagonals` (PairwiseAlignmentParameters, :1334-1348).

Scheme (exact checkpoint/recompute, two device passes over windows of K
diagonals; K = max(minDiagsBetweenTraceBack, traceBackDiagonals + 2)):

  Pass A (forward): windows low-to-high, carrying (F_{k-1}, F_{k-2},
    1/m_{k-1}); stores only the per-window entry carry ("checkpoint",
    2*S*W floats) plus the per-diagonal log scales mf (K floats/window).
    No O(diagonals * band) tensor ever exists.

  Pass B (backward): windows high-to-low. Each window recomputes its
    forward block from its checkpoint, then advances the backward
    recursion through the window carrying the TRUE backward state
    (B_{k1}, B_{k1+1}, 1/mb_{k1}) across the boundary — plus the one-row
    bridge dot needed by diagonalCalculationTotalProbability semantics
    (:636-653). Posterior rows are emitted (and host-thresholded) per
    window; expectation counts accumulate across windows.

Deliberate divergence from the reference (documented per SURVEY.md §7
hard-part 3): the reference seeds a FRESH backward matrix with end-state
probabilities at every traceback point and burns in `traceBackDiagonals`
diagonals before trusting it (:797-817) — an approximation. Carrying the
exact backward state costs nothing here and makes streaming posteriors
bit-comparable to the two-pass engine, so `traceBackDiagonals` only
lower-bounds the window size; `minDiagsBetweenTraceBack` sets the
checkpoint/traceback stride exactly as in the reference.

Memory: window block (K, S, W) fp32 + checkpoints (nW, 2, S, W) + the
per-diagonal scalar streams — e.g. a densely-anchored 1 Mb x 1 Mb pair
at W=64, K=1024 holds < 20 MB live instead of the ~2.5 GB two-pass
F tensor.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from cpecan_tpu.ops import fb as _fb
from cpecan_tpu.ops.fb_wavefront import block_width

# Working-set budget when the backend reports no memory limit (the CPU).
_HOST_BUDGET = 1 << 30


def device_budget_bytes(device=None) -> int:
    """Working-set budget of one device launch: an eighth of what the
    device (by default this process's first) lets JAX allocate
    (memory_stats()["bytes_limit"]), or 1 GiB when the backend reports
    no limit."""
    device = device if device is not None else jax.local_devices()[0]
    limit = (device.memory_stats() or {}).get("bytes_limit")
    return int(limit) // 8 if limit else _HOST_BUDGET


def stream_budget_bytes() -> int:
    """device_budget_bytes(), unless CPECAN_TPU_STREAM_BUDGET sets it."""
    env = os.environ.get("CPECAN_TPU_STREAM_BUDGET")
    return int(env) if env else device_budget_bytes()


def resident_bytes(diagonal_number: int, width: int,
                   state_number: int = 5) -> int:
    """Two-pass bytes for one pair: ~3 (P+1, S, W) fp32 tensors, W
    padded to the kernels' block width."""
    return 3 * (diagonal_number + 1) * state_number * block_width(width) * 4


def should_stream(diagonal_number: int, width: int, state_number: int = 5) -> bool:
    """Streaming activates when one pair's two-pass tensors would exceed
    the budget."""
    return (resident_bytes(diagonal_number, width, state_number)
            > stream_budget_bytes())


def window_rows(p) -> int:
    """Window/checkpoint stride from the live config params."""
    k = max(int(p.minDiagsBetweenTraceBack), int(p.traceBackDiagonals) + 2, 64)
    return -(-k // 8) * 8


def _host_frame(offsets: np.ndarray, widths: np.ndarray):
    """x-frame tensors (numpy) from unpadded band tensors."""
    ks = np.arange(len(offsets), dtype=np.int64)
    xlo = (ks + offsets.astype(np.int64)) // 2
    xhi = xlo + widths - 1
    xoff = np.maximum.accumulate(xlo)
    delta = np.diff(xoff, prepend=xoff[:1])
    jlo = xlo - xoff
    jhi = xhi - xoff
    return (xoff.astype(np.int32), delta.astype(np.int32),
            jlo.astype(np.int32), jhi.astype(np.int32))


def _pad_frame(xoff, delta, jlo, jhi, rows_total):
    """Pad frame arrays to rows_total (+2 slack for d_{k+1}/d_{k+2} reads).
    Padding rows carry an empty band (jhi < jlo) so scans through them are
    exact no-ops, as in pad_band."""
    n = rows_total + 2
    pad = n - len(xoff)
    xoff = np.concatenate([xoff, np.full(pad, xoff[-1], np.int32)])
    delta = np.concatenate([delta, np.zeros(pad, np.int32)])
    jlo = np.concatenate([jlo, np.zeros(pad, np.int32)])
    jhi = np.concatenate([jhi, np.full(pad, -1, np.int32)])
    return xoff, delta, jlo, jhi


def _window_inputs(sx_pad, sy_pad, xoff_g, delta_g, jlo_g, jhi_g,
                   k0, LY, K, W, prob):
    """Streams for rows [k0, k0+K): symbol windows, emissions, frame rows."""
    sl = lambda a, off=0: jax.lax.dynamic_slice(a, (k0 + off,), (K,))
    xoff_w = sl(xoff_g)
    delta_w = sl(delta_g)
    d_km1 = sl(delta_g, -1)
    jlo_w = sl(jlo_g)
    jhi_w = sl(jhi_g)
    ks_w = k0 + jnp.arange(K, dtype=jnp.int32)
    wx, wy = _fb._symbol_windows_scan(sx_pad, sy_pad, xoff_w, delta_w,
                                      LY, W, ks=ks_w)
    return dict(xoff=xoff_w, delta=delta_w, d_km1=d_km1, jlo=jlo_w,
                jhi=jhi_w, ks=ks_w, wx=wx, wy=wy)


@functools.partial(jax.jit, static_argnames=("K", "W"))
def _fwd_window_jit(params, sx_pad, sy_pad, xoff_g, delta_g, jlo_g, jhi_g,
                    k0, LY, ragged_right, carry, K: int, W: int):
    """Pass-A window: advance the forward carry over K rows; returns
    (carry_out, mf_win, fe_win) where fe_win is the per-row log end-dot
    (for log_fwd at row L)."""
    prob = _fb._prob_params(params)
    win = _window_inputs(sx_pad, sy_pad, xoff_g, delta_g, jlo_g, jhi_g,
                         k0, LY, K, W, prob)
    e_x, e_y, e_m = _fb._emissions(prob, win["wx"][:, :W], win["wy"][:, 1:])
    carry_out, F_win, mf_win = _fb.forward_window(
        prob, e_x, e_y, e_m, win["delta"], win["d_km1"],
        win["jlo"], win["jhi"], carry, W, win["ks"])
    end_vec = jnp.where(ragged_right, prob["ragged_end"], prob["end"])
    fe_win = jnp.log(jnp.einsum("ksj,s->k", F_win, end_vec,
                                precision=jax.lax.Precision.HIGHEST))
    return carry_out, mf_win, fe_win


@functools.partial(jax.jit, static_argnames=("K", "W", "mode"))
def _bwd_window_jit(params, sx_pad, sy_pad, xoff_g, delta_g, jlo_g, jhi_g,
                    k0, LY, L, ragged_right, carry_f, carry_b,
                    bridge_at_next, mf_boundary, K: int, W: int, mode: str):
    """Pass-B window: recompute the forward block from the checkpoint
    carry_f, advance the backward carry high-to-low, and emit the
    mode-specific per-row outputs."""
    prob = _fb._prob_params(params)
    win = _window_inputs(sx_pad, sy_pad, xoff_g, delta_g, jlo_g, jhi_g,
                         k0, LY, K, W, prob)
    wx, wy = win["wx"], win["wy"]
    e_x, e_y, e_m = _fb._emissions(prob, wx[:, :W], wy[:, 1:])
    ef_x, ef_y, ef_m = _fb._emissions(prob, wx[:, 1:], wy[:, :W])

    # forward recompute from the checkpoint
    _, F_win, mf_win = _fb.forward_window(
        prob, e_x, e_y, e_m, win["delta"], win["d_km1"],
        win["jlo"], win["jhi"], carry_f, W, win["ks"])

    # backward through the window from the exact carry
    end_vec = jnp.where(ragged_right, prob["ragged_end"], prob["end"])
    d_k1 = jax.lax.dynamic_slice(delta_g, (k0 + 1,), (K,))
    d_k2 = jax.lax.dynamic_slice(delta_g, (k0 + 2,), (K,))
    carry_b_out, B_win, mb_win = _fb.backward_window(
        prob, ef_x, ef_y, ef_m, win["ks"], d_k1, d_k2,
        win["jlo"], win["jhi"], L, end_vec, carry_b, W)

    # per-diagonal totals: dot + match bridge (reference :636-653); the
    # 2-row F halo comes straight from the checkpoint carry
    dot = jnp.einsum("ksj,ksj->k", F_win, B_win,
                     precision=jax.lax.Precision.HIGHEST)
    F1c, F2c, _ = carry_f
    F_rm2 = jnp.concatenate([F2c[None], F1c[None], F_win[:-2]])
    d_sum = win["delta"] + win["d_km1"]
    mid = _fb._select_shift(F_rm2, d_sum - 1)
    t_m = prob["t"][1]
    Mext = jnp.einsum("kfj,ft->ktj", mid, t_m,
                      precision=jax.lax.Precision.HIGHEST) * e_m[:, None, :]
    bridge_at = jnp.einsum("ktj,ktj->k", Mext, B_win,
                           precision=jax.lax.Precision.HIGHEST)
    bridge = jnp.concatenate([bridge_at[1:], bridge_at_next[None]])
    ks_w = win["ks"]
    scale_adj = jnp.exp(-mf_win - mb_win)
    bridge = jnp.where((ks_w >= 1) & (ks_w < L), bridge * scale_adj, 0.0)
    total = dot + bridge
    out = {"mf": mf_win, "mb": mb_win, "total_raw": jnp.log(total),
           "carry_b": carry_b_out, "bridge_at0": bridge_at[0]}

    js = jnp.arange(W, dtype=jnp.int32)
    xs = win["xoff"][:, None] + js[None, :]
    ys = ks_w[:, None] - xs
    slot_ok = ((js[None, :] >= win["jlo"][:, None])
               & (js[None, :] <= win["jhi"][:, None]))
    valid_k = (ks_w >= 1) & (ks_w <= L)

    if mode in ("posterior_match", "posterior_all"):
        inv_total = jnp.where(total > 0, 1.0 / total, 0.0)

        def posterior(state, coord_ok):
            pr = F_win[:, state, :] * B_win[:, state, :] * inv_total[:, None]
            return jnp.where(valid_k[:, None] & slot_ok & coord_ok, pr, 0.0)

        out["post_match"] = posterior(0, (xs > 0) & (ys > 0))
        if mode == "posterior_all":
            out["post_gap_x"] = posterior(1, xs > 0)
            out["post_gap_y"] = posterior(2, ys > 0)

    if mode == "expectation":
        out["trans"], out["emis"] = _fb._expectations(
            prob, F_win, B_win, mf_win, total, win["delta"],
            e_x, e_y, e_m, wx[:, :W], wy[:, 1:], slot_ok, valid_k,
            halo=(F1c, F2c, mf_boundary, win["d_km1"][0]))
    return out


@functools.partial(jax.jit, static_argnames=("W",))
def _init_carry_jit(params, ragged_left, W: int):
    prob = _fb._prob_params(params)
    return _fb.initial_forward_carry(prob, ragged_left, W)


def fb_pass_streaming(params, seq_x_codes, seq_y_codes,
                      offsets: np.ndarray, widths: np.ndarray,
                      lx: int, ly: int, ragged_left: bool,
                      ragged_right: bool, mode: str, width: int,
                      window: int, threshold: float = 0.0):
    """Streaming banded FB for ONE long pair (exact: same results as the
    two-pass engine).

    seq_*_codes: int symbol arrays of the true lengths (no padding).
    offsets/widths: UNPADDED band tensors (length lx+ly+1).
    window: diagonals per checkpoint window (window_rows(p)).

    Returns a dict:
      "log_fwd": float raw end-dot log at L (host f64 recombination adds
        sum(mf)); "mf", "mb", "total_raw": (L+1,) numpy rows (mb[0] and
        total_raw[0] are 0/-inf placeholders — consumers only read rows
        1..L, as in fb_pass);
      posterior modes: "post_entries": {key: (vals, ks, js)} numpy arrays
        of the in-band posteriors >= max(threshold, tiny) per window
        concatenated; "xoff": the frame offsets for (k, j) -> (x, y);
      expectation: "trans" (S,S), "emis" (S,4,4) float64 counts.
    """
    L = int(lx) + int(ly)
    if L == 0:
        raise ValueError("empty pair")
    K = int(window)
    W = int(width)
    nW = -(-L // K)  # windows cover rows [1, 1 + nW*K) ⊇ [1, L]
    rows_total = 1 + nW * K

    xoff, delta, jlo, jhi = _host_frame(np.asarray(offsets),
                                        np.asarray(widths))
    xoff, delta, jlo, jhi = _pad_frame(xoff, delta, jlo, jhi, rows_total)

    sx = np.asarray(seq_x_codes, np.int8)
    sy = np.asarray(seq_y_codes, np.int8)
    pad = np.full(W + 1, _fb._SENTINEL, np.int8)
    sx_pad = jnp.asarray(np.concatenate([pad, sx, pad]))
    sy_pad = jnp.asarray(np.concatenate([pad, sy[::-1], pad]))
    LY = int(ly)

    dev = jnp.asarray
    xoff_d, delta_d = dev(xoff), dev(delta)
    jlo_d, jhi_d = dev(jlo), dev(jhi)

    carry, m0log = _init_carry_jit(params, bool(ragged_left), W)

    # ---- pass A: forward, storing per-window checkpoints + mf ----
    checkpoints = []
    mf_parts = [np.asarray(m0log, np.float64)[None]]
    fe_parts = []
    for w in range(nW):
        k0 = 1 + w * K
        checkpoints.append(carry)
        carry, mf_win, fe_win = _fwd_window_jit(
            params, sx_pad, sy_pad, xoff_d, delta_d, jlo_d, jhi_d,
            jnp.int32(k0), jnp.int32(LY), bool(ragged_right), carry,
            K=K, W=W)
        mf_parts.append(np.asarray(mf_win, np.float64))
        fe_parts.append(np.asarray(fe_win, np.float64))
    mf = np.concatenate(mf_parts)[: L + 1]
    fe = np.concatenate(fe_parts)  # rows 1..nW*K
    log_fwd = float(fe[L - 1])  # fe index 0 is row 1

    out = {"log_fwd": log_fwd, "mf": mf, "windows": nW}
    if mode == "forward":
        out["mb"] = np.zeros(L + 1)
        return out

    # ---- pass B: backward windows high-to-low ----
    S = int(params["start"].shape[0])
    zero_b = (jnp.zeros((S, W), jnp.float32), jnp.zeros((S, W), jnp.float32),
              jnp.float32(1.0))
    carry_b = zero_b
    bridge_at_next = jnp.float32(0.0)
    mb = np.zeros(L + 1)
    total_raw = np.full(L + 1, -np.inf)
    entries = {k: ([], [], []) for k in
               ("post_match", "post_gap_x", "post_gap_y")}
    keys = (("post_match",) if mode == "posterior_match" else
            ("post_match", "post_gap_x", "post_gap_y")
            if mode == "posterior_all" else ())
    trans = None
    emis = None
    for w in range(nW - 1, -1, -1):
        k0 = 1 + w * K
        mf_boundary = jnp.float32(mf[k0 - 1])
        res = _bwd_window_jit(
            params, sx_pad, sy_pad, xoff_d, delta_d, jlo_d, jhi_d,
            jnp.int32(k0), jnp.int32(LY), jnp.int32(L),
            bool(ragged_right), checkpoints[w], carry_b, bridge_at_next,
            mf_boundary, K=K, W=W, mode=mode)
        carry_b = res["carry_b"]
        bridge_at_next = res["bridge_at0"]
        hi = min(k0 + K, L + 1)
        n_rows = hi - k0
        if n_rows > 0:
            mb[k0:hi] = np.asarray(res["mb"], np.float64)[:n_rows]
            total_raw[k0:hi] = np.asarray(
                res["total_raw"], np.float64)[:n_rows]
        thr = max(float(threshold), 1e-9)  # bound emitted entries
        for key in keys:
            block = np.asarray(res[key])  # (K, W)
            ks_loc, js_loc = np.nonzero(block >= thr)
            vals = block[ks_loc, js_loc]
            entries[key][0].append(vals)
            entries[key][1].append(ks_loc + k0)
            entries[key][2].append(js_loc)
        if mode == "expectation":
            t_w = np.asarray(res["trans"], np.float64)
            e_w = np.asarray(res["emis"], np.float64)
            trans = t_w if trans is None else trans + t_w
            emis = e_w if emis is None else emis + e_w

    out["mb"] = mb
    out["total_raw"] = total_raw
    if keys:
        out["xoff"] = xoff
        out["post_entries"] = {
            key: tuple(np.concatenate(parts) if parts else np.zeros(0)
                       for parts in entries[key])
            for key in keys}
    if mode == "expectation":
        out["trans"] = trans
        out["emis"] = emis
    return out
