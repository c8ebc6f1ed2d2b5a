"""Banded forward-backward as fused Pallas kernels for NVIDIA GPUs.

The scan engine (ops/fb.py) runs one XLA loop iteration per
anti-diagonal (~2,000 for a 1 kb pair, per pass) and materializes whole
(B, P, S, W) forward and backward tensors for its vectorized reductions.
Here each pass is one kernel launch (Pallas, lowered through Triton):

 * **Forward kernel**: every program owns G pairs and walks all their
   diagonals in an in-kernel loop. Slot j of the band rides the block's
   lanes. The normalized rows F_k go to an HBM buffer (the backward pass
   needs them anyway); the +-1 neighbor shifts of the recurrence are
   gathered back from that buffer after a block barrier, so no register
   shuffle or slice is needed.

 * **Backward kernel**: walks the diagonals high to low with B_{k+1},
   B_{k+2} in a 3-row ring buffer (one barrier per row), recomputes the
   per-diagonal total (forward.backward dot plus the one-step match
   bridge of diagonalCalculationTotalProbability, reference :636-653)
   and writes only what the mode asks for: the posterior rows, or
   Baum-Welch expected counts accumulated in registers (EM E-step; no
   posterior tensor at all).

Emissions are looked up in-kernel from the pair's symbol codes and the
5-entry / 5x5 tables (sentinel code 5 maps to 0), so nothing per
(row, slot) is precomputed in HBM. The transition contraction is
unrolled over the statically nonzero (class, from, to) triples of the
state machine (13 for the 5-state, 9 for the 3-state).

Numerics follow ops/fb.py exactly (same scaled-probability recurrence,
same NORM_EVERY rescale schedule), so the scan engine is the test
oracle. `interpret=True` runs the same kernels in the Pallas
interpreter on any backend; it is for tests only.
"""

from __future__ import annotations

import functools
import weakref

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from cpecan_tpu.ops import fb as _fb

# Widest band block the kernels take; wider bands run on the scan engine
# (one block holds S x W floats per live array, in registers).
MAX_WIDTH = 1024

# Emission table layout: gap-x (6), gap-y (6), match (6 x 6); index 5 is
# the sentinel symbol with probability 0.
_GX, _GY, _GM = 0, 6, 12
_NSYM = 6

MODES = ("forward", "posterior_match", "posterior_all", "expectation")

# Largest flat index into a kernel buffer (int32 offsets).
_MAX_INDEX = 2**31 - 1


def supported(mode: str) -> bool:
    return mode in MODES


def nonzero_transitions(t_log: np.ndarray):
    """Static (class, from, to) triples of active transitions from the
    numpy/host copy of the (3, S, S) log transition tensor."""
    t = np.asarray(t_log)
    triples = []
    for c in range(3):
        for f in range(t.shape[1]):
            for to in range(t.shape[2]):
                if np.isfinite(t[c, f, to]):
                    triples.append((c, f, to))
    return tuple(triples)


# Device transition tensor -> triples: computing the triples costs a
# device->host fetch, paid once per distinct tensor instead of once per
# launch. Weak references, so this cache never keeps arrays alive.
_NZ_CACHE: dict = {}


def nonzero_transitions_of(t_dev):
    """nonzero_transitions of a (possibly device-resident) transition
    tensor, cached by array identity (weakly referenced)."""
    hit = _NZ_CACHE.get(id(t_dev))
    if hit is not None and hit[0]() is t_dev:
        return hit[1]
    nz = nonzero_transitions(jax.device_get(t_dev))
    if len(_NZ_CACHE) > 64:
        _NZ_CACHE.clear()
    try:
        _NZ_CACHE[id(t_dev)] = (weakref.ref(t_dev), nz)
    except TypeError:
        pass  # non-weakref-able array type: skip caching
    return nz


def block_width(width: int) -> int:
    """Kernel block width for a band of `width` slots: the next power of
    two (Triton block shapes), at least 8."""
    return max(8, 1 << (max(int(width), 1) - 1).bit_length())


def tiles(block_w: int) -> tuple[int, int]:
    """(pairs per program G, warps per program) for a block width: the
    block is G x W slots with about one slot per thread."""
    group = max(1, 64 // block_w)
    warps = max(1, min(8, group * block_w // 32))
    return group, warps


# ---------------------------------------------------------------------------
# Kernel helpers (all arrays are (G, W) slot tiles or (G, 1) per-pair columns)
# ---------------------------------------------------------------------------


class _Ctx:
    """Per-program index arithmetic shared by both kernels."""

    def __init__(self, G, W, P, S, rows):
        self.G, self.W, self.P, self.S, self.rows = G, W, P, S, rows
        pid = pl.program_id(0)
        self.b = pid * G + jax.lax.broadcasted_iota(jnp.int32, (G, 1), 0)
        self.js = jax.lax.broadcasted_iota(jnp.int32, (G, W), 1)
        self.pid = pid

    def frame(self, ref, k):
        """(G, 1) per-pair value of a (B, rows + 2) frame stream at row k."""
        return ref[self.b * (self.rows + 2) + k]

    def f_index(self, k, s):
        """Flat offset of F row k, state s, slot 0 (layout [b][k][s][j])."""
        return (self.b * self.rows + k) * (self.S * self.W) + s * self.W

    def shifted(self, ref, base, amount):
        """out[g, j] = row[g, j + amount[g]] of the row at `base`, zero
        outside [0, W)."""
        src = self.js + amount
        ok = (src >= 0) & (src < self.W)
        v = ref[base + jnp.clip(src, 0, self.W - 1)]
        return jnp.where(ok, v, 0.0)

    def symbols(self, sx_ref, sy_ref, lx, ly, x, y):
        """Symbol codes at sequence positions x, y (sentinel 5 outside
        [0, lx) / [0, ly))."""
        okx = (x >= 0) & (x < lx)
        oky = (y >= 0) & (y < ly)
        cx = sx_ref[self.b * self.P + jnp.clip(x, 0, self.P - 1)]
        cy = sy_ref[self.b * self.P + jnp.clip(y, 0, self.P - 1)]
        return jnp.where(okx, cx, 5), jnp.where(oky, cy, 5)


def _emissions(tab_ref, cx, cy):
    return (tab_ref[_GX + cx], tab_ref[_GY + cy],
            tab_ref[_GM + cx * _NSYM + cy])


def _row_max(vals):
    """(G, 1) per-pair max over states and slots."""
    m = jnp.max(vals[0], axis=1, keepdims=True)
    for v in vals[1:]:
        m = jnp.maximum(m, jnp.max(v, axis=1, keepdims=True))
    return m


def _row_sum(v):
    return jnp.sum(v, axis=1, keepdims=True)


def _norm_row(k):
    """fb.norm_flags for one traced diagonal index."""
    return jax.lax.rem(k, _fb.NORM_EVERY) == _fb.NORM_EVERY - 1


def _rescale(vals, do_norm, hold=None):
    """On rescale rows divide a row's states by their per-pair max and
    return (vals, log scale, 1/scale); other rows pass through with scale
    1. `hold` (G, 1) forces scale 1 (the backward pass's end row). A
    branch, so the reduction runs only on rescale rows."""
    G = vals[0].shape[0]

    def norm(vals):
        m = _row_max(vals)
        ok = m > 0 if hold is None else (m > 0) & ~hold
        m = jnp.where(ok, m, 1.0)
        r = 1.0 / m
        return [v * r for v in vals], jnp.log(m), r

    def keep(vals):
        return (list(vals), jnp.zeros((G, 1), jnp.float32),
                jnp.ones((G, 1), jnp.float32))

    return jax.lax.cond(do_norm, norm, keep, list(vals))


# ---------------------------------------------------------------------------
# Forward kernel
# ---------------------------------------------------------------------------


def _fwd_kernel(t_ref, tab_ref, sx_ref, sy_ref, lx_ref, ly_ref, xoff_ref,
                jlo_ref, jhi_ref, f0_ref, f_ref, mf_ref,
                *, S, nz, G, W, P, interpret):
    """Forward wavefront over G pairs: writes the per-diagonal normalized
    rows F_k (all states) and the log scales mf_k (0 on rows that are not
    rescaled, see fb.norm_flags)."""
    rows = P + 1
    c = _Ctx(G, W, P, S, rows)
    barrier = (lambda: None) if interpret else plgpu.debug_barrier
    js = c.js
    lx = lx_ref[c.b]
    ly = ly_ref[c.b]
    T = {tr: t_ref[(tr[0] * S + tr[1]) * S + tr[2]] for tr in nz}
    xs_rows = sorted({f for cl, f, t in nz if cl == 0})
    mid_rows = sorted({f for cl, f, t in nz if cl == 1})
    ys_rows = sorted({f for cl, f, t in nz if cl == 2})

    for s in range(S):
        f_ref[c.f_index(0, s) + js] = jnp.where(
            js == 0, f0_ref[c.b * S + s], 0.0)
    mf_ref[c.b * rows] = jnp.zeros((G, 1), jnp.float32)
    barrier()

    def row(k, carry):
        invm1, d_km1 = carry
        xo = c.frame(xoff_ref, k)
        d = xo - c.frame(xoff_ref, k - 1)
        ok = (js >= c.frame(jlo_ref, k)) & (js <= c.frame(jhi_ref, k))
        x = xo + js
        cx, cy = c.symbols(sx_ref, sy_ref, lx, ly, x - 1, k - x - 1)
        ex, ey, em = _emissions(tab_ref, cx, cy)
        ex = jnp.where(ok, ex, 0.0)
        ey = jnp.where(ok, ey, 0.0)
        em = jnp.where(ok, em, 0.0) * invm1
        has2 = (k >= 2).astype(jnp.float32)
        k2 = jnp.maximum(k - 2, 0)
        lower = {f: c.shifted(f_ref, c.f_index(k - 1, f), d - 1) * ex
                 for f in xs_rows}
        upper = {f: c.shifted(f_ref, c.f_index(k - 1, f), d) * ey
                 for f in ys_rows}
        middle = {f: c.shifted(f_ref, c.f_index(k2, f), d + d_km1 - 1)
                  * (em * has2) for f in mid_rows}
        cur = [None] * S
        for tr in nz:
            cl, f, t = tr
            term = (lower, middle, upper)[cl][f] * T[tr]
            cur[t] = term if cur[t] is None else cur[t] + term
        cur = [jnp.zeros((G, W), jnp.float32) if v is None else v
               for v in cur]
        cur, mf, r = _rescale(cur, _norm_row(k))
        for s in range(S):
            f_ref[c.f_index(k, s) + js] = cur[s]
        mf_ref[c.b * rows + k] = mf
        barrier()
        return r, d

    init = (jnp.ones((G, 1), jnp.float32), jnp.zeros((G, 1), jnp.int32))
    jax.lax.fori_loop(1, P + 1, row, init)


# ---------------------------------------------------------------------------
# Backward kernel (posteriors or expected counts)
# ---------------------------------------------------------------------------


def _bwd_kernel(t_ref, tab_ref, sx_ref, sy_ref, lx_ref, ly_ref, xoff_ref,
                jlo_ref, jhi_ref, end_ref, f_ref, mf_ref, *out_refs,
                S, nz, G, W, P, mode, interpret):
    """Backward wavefront over G pairs, high-to-low, with the mode's
    reductions fused in. out_refs: posterior rows (1 or 3) or
    (trans, emis); then mb, total_raw and the B ring buffer."""
    rows = P + 1
    c = _Ctx(G, W, P, S, rows)
    barrier = (lambda: None) if interpret else plgpu.debug_barrier
    expect = mode == "expectation"
    n_post = 0 if expect else (3 if mode == "posterior_all" else 1)
    if expect:
        trans_ref, emis_ref = out_refs[:2]
    posts = out_refs[:n_post]
    mb_ref, tot_ref, ring_ref = out_refs[-3:]

    js = c.js
    lx = lx_ref[c.b]
    ly = ly_ref[c.b]
    L = lx + ly
    T = {tr: t_ref[(tr[0] * S + tr[1]) * S + tr[2]] for tr in nz}
    x_targets = sorted({t for cl, f, t in nz if cl == 0})
    m_targets = sorted({t for cl, f, t in nz if cl == 1})
    y_targets = sorted({t for cl, f, t in nz if cl == 2})
    bridge_from = [(f, T[(1, f, t)]) for cl, f, t in nz if cl == 1 and t == 0]
    xs_rows = sorted({f for cl, f, t in nz if cl == 0})
    mid_rows = sorted({f for cl, f, t in nz if cl == 1})
    ys_rows = sorted({f for cl, f, t in nz if cl == 2})
    zero = jnp.zeros((G, W), jnp.float32)

    def ring(k, s):
        return (c.b * 3 + jax.lax.rem(k, 3)) * (S * W) + s * W

    for slot in range(3):
        for s in range(S):
            ring_ref[(c.b * 3 + slot) * (S * W) + s * W + js] = zero
    mb_ref[c.b * rows] = jnp.zeros((G, 1), jnp.float32)
    tot_ref[c.b * rows] = jnp.zeros((G, 1), jnp.float32)
    for post in posts:
        post_row0 = c.b * (rows * W) + js
        post[post_row0] = zero
    barrier()

    def row(i, carry):
        k = P - i
        invb1, acc_t, acc_e = carry
        xo = c.frame(xoff_ref, k)
        xo_m1 = c.frame(xoff_ref, k - 1)
        xo_p1 = c.frame(xoff_ref, k + 1)
        d_k = xo - xo_m1
        d1 = xo_p1 - xo
        d2 = c.frame(xoff_ref, k + 2) - xo_p1
        ok = (js >= c.frame(jlo_ref, k)) & (js <= c.frame(jhi_ref, k))
        x = xo + js
        y = k - x

        # future-cell emissions (symbols consumed moving out of the cell)
        fx, fy = c.symbols(sx_ref, sy_ref, lx, ly, x, y)
        efx, efy, efm = _emissions(tab_ref, fx, fy)
        efx = jnp.where(ok, efx, 0.0)
        efy = jnp.where(ok, efy, 0.0)
        efm = jnp.where(ok, efm, 0.0) * invb1
        bx = {t: c.shifted(ring_ref, ring(k + 1, t), 1 - d1) * efx
              for t in x_targets}
        bm = {t: c.shifted(ring_ref, ring(k + 2, t), 1 - d1 - d2) * efm
              for t in m_targets}
        by = {t: c.shifted(ring_ref, ring(k + 1, t), -d1) * efy
              for t in y_targets}
        raw = [None] * S
        for tr in nz:
            cl, f, t = tr
            term = (bx, bm, by)[cl][t] * T[tr]
            raw[f] = term if raw[f] is None else raw[f] + term
        at_end = k == L  # (G, 1)
        raw = [jnp.where(at_end, jnp.where(ok, end_ref[c.b * S + f], 0.0),
                         zero if v is None else v)
               for f, v in enumerate(raw)]
        Bk, mb, r = _rescale(raw, _norm_row(k), hold=at_end)
        for s in range(S):
            ring_ref[ring(k, s) + js] = Bk[s]
        mb_ref[c.b * rows + k] = mb

        # per-diagonal total: F_k . B_k plus the match bridge from F_{k-1}
        # to B_{k+1} (reference :636-653), in diagonal k's scale frame
        Fk = [f_ref[c.f_index(k, s) + js] for s in range(S)]
        dot = _row_sum(Fk[0] * Bk[0])
        for s in range(1, S):
            dot = dot + _row_sum(Fk[s] * Bk[s])
        dmid1 = d1 + d_k - 1
        bvec = zero
        for f, tv in bridge_from:
            bvec = bvec + c.shifted(f_ref, c.f_index(k - 1, f), dmid1) * tv
        x1 = xo_p1 + js
        ox, oy = c.symbols(sx_ref, sy_ref, lx, ly, x1 - 1, k - x1)
        em_next = tab_ref[_GM + ox * _NSYM + oy]
        b1_match = ring_ref[ring(k + 1, 0) + js]
        mf_k = mf_ref[c.b * rows + k]
        bridge = _row_sum(bvec * em_next * b1_match) * jnp.exp(-mf_k) * r
        total = dot + jnp.where((k >= 1) & (k < L), bridge, 0.0)
        tot_ref[c.b * rows + k] = jnp.log(total)

        valid = (k <= L) & (total > 0)
        inv_total = jnp.where(valid, 1.0 / jnp.where(valid, total, 1.0), 0.0)
        if not expect:
            prow = c.b * (rows * W) + k * W + js
            keep = ok & (x > 0)
            posts[0][prow] = jnp.where(keep & (y > 0),
                                       Fk[0] * Bk[0] * inv_total, 0.0)
            if n_post == 3:
                posts[1][prow] = jnp.where(keep, Fk[1] * Bk[1] * inv_total,
                                           0.0)
                posts[2][prow] = jnp.where(ok & (y > 0),
                                           Fk[2] * Bk[2] * inv_total, 0.0)
        else:
            # expected counts: p = F_prev[f] * T * e * B_k[t] / total_k
            # (reference diagonalCalculationExpectations :735-746)
            xo_m2 = c.frame(xoff_ref, jnp.maximum(k - 2, 0))
            d_km1 = xo_m1 - xo_m2
            mf_km1 = mf_ref[c.b * rows + k - 1]
            adj1 = jnp.exp(-mf_k)
            adj2 = jnp.exp(-mf_k - mf_km1) * (k >= 2).astype(jnp.float32)
            cx, cy = c.symbols(sx_ref, sy_ref, lx, ly, x - 1, y - 1)
            ex, ey, em = _emissions(tab_ref, cx, cy)
            k2 = jnp.maximum(k - 2, 0)
            nb = (
                {f: c.shifted(f_ref, c.f_index(k - 1, f), d_k - 1)
                 * (ex * adj1) for f in xs_rows},
                {f: c.shifted(f_ref, c.f_index(k2, f), d_k + d_km1 - 1)
                 * (em * adj2) for f in mid_rows},
                {f: c.shifted(f_ref, c.f_index(k - 1, f), d_k)
                 * (ey * adj1) for f in ys_rows},
            )
            w = jnp.where(ok, inv_total, 0.0)
            Bw = [v * w for v in Bk]
            q = [zero] * S
            acc_t = list(acc_t)
            for i, tr in enumerate(nz):
                cl, f, t = tr
                n_e = nb[cl][f]
                acc_t[i] = acc_t[i] + n_e * Bw[t]
                q[t] = q[t] + n_e * T[tr]
            sym = jnp.where((cx < 4) & (cy < 4), cx * 4 + cy, 16)
            acc_e = list(acc_e)
            for t in range(S):
                qt = q[t] * Bw[t]
                for ab in range(16):
                    acc_e[t * 16 + ab] = acc_e[t * 16 + ab] + jnp.where(
                        sym == ab, qt, 0.0)
            acc_t, acc_e = tuple(acc_t), tuple(acc_e)
        barrier()
        return jnp.where(at_end, 1.0, r), acc_t, acc_e

    n_acc_t = len(nz) if expect else 0
    n_acc_e = 16 * S if expect else 0
    init = (jnp.ones((G, 1), jnp.float32), (zero,) * n_acc_t,
            (zero,) * n_acc_e)
    _, acc_t, acc_e = jax.lax.fori_loop(0, P, row, init)

    if expect:
        sums = {}
        for i, tr in enumerate(nz):
            v = jnp.sum(acc_t[i]) * T[tr]
            key = tr[1] * S + tr[2]
            sums[key] = v if key not in sums else sums[key] + v
        for key in range(S * S):
            trans_ref[c.pid * (S * S) + key] = sums.get(key, jnp.float32(0))
        for i in range(16 * S):
            emis_ref[c.pid * (16 * S) + i] = jnp.sum(acc_e[i])


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def _prepare(params, offsets, widths, ragged_left, ragged_right, P):
    """Per-pair frame streams (padded to P + 3 rows: two rows of slack
    for the backward pass's k+1 / k+2 reads), start row scale, end
    vector and the emission table."""
    prob = _fb._prob_params(params)
    xoff, _, jlo, jhi = jax.vmap(_fb._frame_from_band)(offsets, widths)
    n = P + 3 - xoff.shape[1]
    xoff = jnp.concatenate(
        [xoff, jnp.broadcast_to(xoff[:, -1:], (xoff.shape[0], n))], axis=1)
    jlo = jnp.pad(jlo, [(0, 0), (0, n)])
    jhi = jnp.pad(jhi, [(0, 0), (0, n)], constant_values=-1)
    start = jnp.where(ragged_left[:, None], prob["ragged_start"][None],
                      prob["start"][None])
    m0 = jnp.max(start, axis=1, keepdims=True)
    m0 = jnp.where(m0 > 0, m0, 1.0)
    end = jnp.where(ragged_right[:, None], prob["ragged_end"][None],
                    prob["end"][None])
    z1 = jnp.zeros((1,), jnp.float32)
    gm = jnp.pad(prob["em_match"], [(0, 1), (0, 1)])
    tab = jnp.concatenate([prob["em_gap_x"], z1, prob["em_gap_y"], z1,
                           gm.reshape(-1)])
    return dict(xoff=xoff, jlo=jlo, jhi=jhi, f0=start / m0,
                m0log=jnp.log(m0[:, 0]), end=end, tab=tab,
                t=prob["t"].reshape(-1))


@functools.partial(
    jax.jit,
    static_argnames=("nz", "mode", "width", "group", "warps", "interpret"))
def _wavefront_jit(params, sx, sy, offsets, widths, lx, ly, ragged_left,
                   ragged_right, *, nz, mode, width, group, warps,
                   interpret):
    S = params["start"].shape[0]
    B = sx.shape[0]
    P = offsets.shape[1] - 1
    W = block_width(width)
    G = group
    # batch padded to a multiple of G with empty pairs (length 0: no
    # emissions, no counts)
    NB = -(-B // G) * G
    rows = P + 1
    sx = jnp.pad(sx, [(0, 0), (0, max(P - sx.shape[1], 0))])[:, :P]
    sy = jnp.pad(sy, [(0, 0), (0, max(P - sy.shape[1], 0))])[:, :P]

    def pad_batch(a):
        return jnp.pad(a, [(0, NB - B)] + [(0, 0)] * (a.ndim - 1))

    sx, sy, offsets, widths, lx, ly, ragged_left, ragged_right = map(
        pad_batch, (sx, sy, offsets, widths, lx, ly, ragged_left,
                    ragged_right))
    pre = _prepare(params, offsets, widths, ragged_left, ragged_right, P)
    flat = lambda a: a.reshape(-1)
    ins = (pre["t"], pre["tab"], flat(sx.astype(jnp.int32)),
           flat(sy.astype(jnp.int32)), lx.astype(jnp.int32),
           ly.astype(jnp.int32), flat(pre["xoff"]), flat(pre["jlo"]),
           flat(pre["jhi"]))
    call = functools.partial(
        pl.pallas_call, grid=(NB // G,), backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=warps, num_stages=1),
        interpret=interpret)
    dims = dict(S=S, nz=nz, G=G, W=W, P=P, interpret=interpret)
    f32 = jnp.float32

    F, mf = call(
        functools.partial(_fwd_kernel, **dims),
        out_shape=[jax.ShapeDtypeStruct((NB * rows * S * W,), f32),
                   jax.ShapeDtypeStruct((NB * rows,), f32)],
        name="fb_forward",
    )(*ins, flat(pre["f0"]))
    mf = mf.reshape(NB, rows).at[:, 0].add(pre["m0log"])
    L = jnp.clip(lx + ly, 0, P)
    FL = jnp.take_along_axis(F.reshape(NB, rows, S * W),
                             L[:, None, None], axis=1).reshape(NB, S, W)
    log_fwd = jnp.log(jnp.einsum("bsw,bs->b", FL, pre["end"],
                                 precision=jax.lax.Precision.HIGHEST))
    out = {"mf": mf[:B], "log_fwd": log_fwd[:B]}
    if mode == "forward":
        out["mb"] = jnp.zeros_like(out["mf"])
        return out

    if mode == "expectation":
        shapes = [jax.ShapeDtypeStruct((NB // G * S * S,), f32),
                  jax.ShapeDtypeStruct((NB // G * 16 * S,), f32)]
    else:
        n_post = 3 if mode == "posterior_all" else 1
        shapes = [jax.ShapeDtypeStruct((NB * rows * W,), f32)] * n_post
    shapes += [jax.ShapeDtypeStruct((NB * rows,), f32)] * 2
    shapes += [jax.ShapeDtypeStruct((NB * 3 * S * W,), f32)]
    res = call(
        functools.partial(_bwd_kernel, mode=mode, **dims),
        out_shape=shapes, name="fb_backward_" + mode,
    )(*ins, flat(pre["end"]), F, flat(mf))
    out["mb"] = res[-3].reshape(NB, rows)[:B]
    out["total_raw"] = res[-2].reshape(NB, rows)[:B]
    if mode == "expectation":
        out["trans"] = jnp.sum(res[0].reshape(-1, S, S), axis=0)
        out["emis"] = jnp.sum(res[1].reshape(-1, S, 4, 4), axis=0)
        return out
    keys = ("post_match", "post_gap_x", "post_gap_y")
    for key, post in zip(keys, res[:-3]):
        out[key] = post.reshape(NB, rows, W)[:B, :, :width]
    return out


def fb_pass_batch_wavefront(params, sx, sy, offsets, widths, lx, ly,
                            ragged_left, ragged_right,
                            mode: str = "posterior_match", width: int = 0,
                            interpret: bool = False, nz=None):
    """Batched banded FB pass on the fused kernels.

    Same contract as ops.fb_batch.fb_pass_batch_scan for every mode (in
    expectation mode trans/emis come back batch-summed, with per-pair mb
    and total_raw for the host-side float64 likelihood recombination).
    `nz` (static transition triples) must be supplied when params are
    tracers, e.g. under shard_map or an outer jit. `interpret=True` runs
    the kernels in the Pallas interpreter (tests on a machine without a
    GPU)."""
    if not supported(mode):
        raise ValueError(f"wavefront engine does not support mode={mode!r}")
    if int(width) > MAX_WIDTH:
        raise ValueError(f"band width {width} exceeds MAX_WIDTH {MAX_WIDTH}")
    if nz is None:
        nz = nonzero_transitions_of(params["t"])
    group, warps = tiles(block_width(width))
    # flat int32 offsets into the F buffer: split batches that would
    # overflow them
    S = int(params["start"].shape[0])
    per_pair = int(offsets.shape[1]) * S * block_width(width)
    max_pairs = max(group, _MAX_INDEX // per_pair // group * group)
    B = int(sx.shape[0])
    if B > max_pairs:
        parts = [fb_pass_batch_wavefront(
            params, *(a[i:i + max_pairs] for a in (
                sx, sy, offsets, widths, lx, ly, ragged_left, ragged_right)),
            mode=mode, width=width, interpret=interpret, nz=nz)
            for i in range(0, B, max_pairs)]
        return {k: (sum(p[k] for p in parts) if k in ("trans", "emis")
                    else jnp.concatenate([p[k] for p in parts]))
                for k in parts[0]}
    return _wavefront_jit(
        params, jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(offsets),
        jnp.asarray(widths), jnp.asarray(lx), jnp.asarray(ly),
        jnp.asarray(ragged_left), jnp.asarray(ragged_right), nz=nz,
        mode=mode, width=int(width), group=group, warps=warps,
        interpret=bool(interpret))
