"""Top-level pairwise alignment APIs.

Equivalents of the reference core public functions
(impl/pairwiseAligner.c:1431-1513):

  get_aligned_pairs(_using_anchors)       -> posterior match pairs
  get_aligned_pairs_with_indels(...)      -> match + gapX + gapY pairs
  get_expectations(_using_anchors)        -> EM expected counts into an Hmm
  compute_forward_probability             -> banded forward log-prob

Pipeline per pair: anchors (host seed/chain) -> large-gap split (host) ->
per-chunk banded FB on device (bucketed shapes so jit caches) -> pair
extraction/coordinate correction (host). Batched multi-pair execution lives
in align.batch.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from cpecan_tpu.config import PairwiseAlignmentParameters
from cpecan_tpu.models.hmm import Hmm
from cpecan_tpu.models.state_machine import StateMachine
from cpecan_tpu.align.anchors import get_anchors
from cpecan_tpu.align.split import get_split_points, split_anchors
from cpecan_tpu.ops import fb
from cpecan_tpu.ops.band import construct_band, pad_band
from cpecan_tpu.utils import metrics
from cpecan_tpu.ops import pairs as pairs_mod
from cpecan_tpu.utils.symbols import encode


def _bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two (bounded recompilation)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _width_bucket(w: int) -> int:
    """Band width bucket: the GPU kernels' block width (the next power of
    two) up to fb_wavefront.MAX_WIDTH, multiples of it beyond (those
    bands run on the scan engine)."""
    from cpecan_tpu.ops.fb_wavefront import MAX_WIDTH, block_width

    if w <= MAX_WIDTH:
        return block_width(w)
    return -(-w // MAX_WIDTH) * MAX_WIDTH


def _run_chunk(sm: StateMachine, seq_x: str, seq_y: str, anchors,
               p: PairwiseAlignmentParameters, ragged_left: bool,
               ragged_right: bool, mode: str):
    """One banded FB chunk on device; returns (engine outputs, band)."""
    lx, ly = len(seq_x), len(seq_y)
    arr = np.asarray(anchors if isinstance(anchors, np.ndarray)
                     else list(anchors), dtype=np.int64)
    if arr.ndim == 1:
        arr = arr.reshape(0, 3)
    if p.dynamicAnchorExpansion:
        band = construct_band(arr, lx, ly, expansion=None)
    else:
        band = construct_band(arr[:, :2], lx, ly, p.diagonalExpansion)
    P = _bucket(band.diagonal_number)
    W = _width_bucket(band.frame_width())
    offsets, widths, L = pad_band(band, P)

    sx = np.zeros(P, dtype=np.int32)
    sy = np.zeros(P, dtype=np.int32)
    sx[:lx] = encode(seq_x)
    sy[:ly] = encode(seq_y)

    with metrics.stage("fb_pass"):
        out = fb.fb_pass(
            sm.device_params(), jnp.asarray(sx), jnp.asarray(sy),
            jnp.asarray(offsets), jnp.asarray(widths),
            jnp.int32(lx), jnp.int32(ly),
            bool(ragged_left), bool(ragged_right), mode=mode, width=W)
        out = {k: np.asarray(v) for k, v in out.items()}
    metrics.add("dp_cells", int(band.widths.sum()))
    return out, band, offsets


def _iterate_chunks(seq_x: str, seq_y: str, anchor_pairs,
                    p: PairwiseAlignmentParameters,
                    ragged_left: bool, ragged_right: bool):
    """Split by large gaps and yield (rect, local anchors, ragged flags)
    (reference getPosteriorProbsWithBandingSplittingAlignmentsByLargeGaps
    :1273-1326: ragged flags propagate to the outermost chunks only)."""
    lx, ly = len(seq_x), len(seq_y)
    split_points = get_split_points(
        anchor_pairs, lx, ly, p.splitMatrixBiggerThanThis, ragged_left, ragged_right)
    n = len(split_points)
    for i, (rect, local_anchors) in enumerate(split_anchors(anchor_pairs, split_points)):
        rl = ragged_left or i > 0
        rr = ragged_right or i < n - 1
        yield rect, local_anchors, rl, rr


def get_aligned_pairs_using_anchors(sm: StateMachine, seq_x: str, seq_y: str,
                                    anchor_pairs, p: PairwiseAlignmentParameters,
                                    ragged_left: bool = False,
                                    ragged_right: bool = False) -> np.ndarray:
    """Posterior match pairs (prob, x, y) above p.threshold.

    Delegates to the batched chunk runner (align/batch.py): even a single
    pair's large-gap chunks execute as one shape-bucketed device batch."""
    from cpecan_tpu.align import batch as batch_mod

    return batch_mod.batch_posteriors(
        sm, [(seq_x, seq_y, anchor_pairs, ragged_left, ragged_right)], p,
        mode="posterior_match")[0]


def get_aligned_pairs_with_indels_using_anchors(
        sm: StateMachine, seq_x: str, seq_y: str, anchor_pairs,
        p: PairwiseAlignmentParameters,
        ragged_left: bool = False, ragged_right: bool = False):
    """(match_pairs, gap_x_pairs, gap_y_pairs)."""
    from cpecan_tpu.align import batch as batch_mod

    return batch_mod.batch_posteriors(
        sm, [(seq_x, seq_y, anchor_pairs, ragged_left, ragged_right)], p,
        mode="posterior_all")[0]


def get_shifted_mea_alignment(sm: StateMachine, seq_x: str, seq_y: str,
                              anchor_pairs, p: PairwiseAlignmentParameters,
                              ragged_left: bool = False,
                              ragged_right: bool = False):
    """Posteriors -> MEA decode -> left-shift, returning (pairs, score):
    the reference convenience decode getShiftedMEAAlignment
    (impl/pairwiseAligner.c:1767-1790)."""
    from cpecan_tpu.ops import mea as mea_mod

    match, gap_x, gap_y = get_aligned_pairs_with_indels_using_anchors(
        sm, seq_x, seq_y, anchor_pairs, p, ragged_left, ragged_right)
    # MEA wants a topological order of the (x<x', y<y') partial order;
    # diagonal-major is one (batch chunks may interleave emission order)
    match = match[np.lexsort((match["x"], match["x"] + match["y"]))]
    alignment, score = mea_mod.mea_alignment(
        match, gap_x, gap_y, len(seq_x), len(seq_y), p.gapGamma)
    return mea_mod.left_shift_alignment(alignment, seq_x, seq_y), score


def get_expectations_using_anchors(sm: StateMachine, hmm: Hmm, seq_x: str,
                                   seq_y: str, anchor_pairs,
                                   p: PairwiseAlignmentParameters,
                                   ragged_left: bool = False,
                                   ragged_right: bool = False) -> None:
    """Accumulate Baum-Welch expected counts into hmm (reference
    getExpectationsUsingAnchors :1500-1505). Likelihood accumulates the
    per-diagonal total log-prob, mirroring the reference's per-diagonal
    accumulation hack (:743)."""
    for (x1, y1, x2, y2), local, rl, rr in _iterate_chunks(
            seq_x, seq_y, anchor_pairs, p, ragged_left, ragged_right):
        if x2 - x1 == 0 and y2 - y1 == 0:
            continue
        out, band, offsets = _run_chunk(
            sm, seq_x[x1:x2], seq_y[y1:y2], local, p, rl, rr, "expectation")
        hmm.transitions += np.asarray(out["trans"], dtype=np.float64)
        hmm.emissions += np.asarray(out["emis"], dtype=np.float64)
        L = band.diagonal_number
        cf = np.cumsum(out["mf"][: L + 1].astype(np.float64))
        cb = np.cumsum(out["mb"][: L + 1][::-1].astype(np.float64))[::-1]
        totals = out["total_raw"][1 : L + 1].astype(np.float64) + cf[1:] + cb[1:]
        hmm.likelihood += float(np.sum(totals))


def compute_forward_probability(seq_x: str, seq_y: str, anchor_pairs,
                                p: PairwiseAlignmentParameters,
                                sm: StateMachine,
                                ragged_left: bool = False,
                                ragged_right: bool = False) -> float:
    """Banded forward log-probability (reference computeForwardProbability
    :936-949 — no large-gap splitting, single banded pass)."""
    lx, ly = len(seq_x), len(seq_y)
    if lx + ly == 0:
        return 0.0
    out, band, _ = _run_chunk(sm, seq_x, seq_y, anchor_pairs, p,
                              ragged_left, ragged_right, "forward")
    L = band.diagonal_number
    return float(out["log_fwd"]) + float(np.sum(out["mf"][: L + 1], dtype=np.float64))


def get_aligned_pairs(sm: StateMachine, seq_x: str, seq_y: str,
                      p: PairwiseAlignmentParameters,
                      ragged_left: bool = False,
                      ragged_right: bool = False) -> np.ndarray:
    anchors = get_anchors(seq_x, seq_y, p)
    return get_aligned_pairs_using_anchors(
        sm, seq_x, seq_y, anchors, p, ragged_left, ragged_right)


def get_aligned_pairs_with_indels(sm: StateMachine, seq_x: str, seq_y: str,
                                  p: PairwiseAlignmentParameters,
                                  ragged_left: bool = False,
                                  ragged_right: bool = False):
    anchors = get_anchors(seq_x, seq_y, p)
    return get_aligned_pairs_with_indels_using_anchors(
        sm, seq_x, seq_y, anchors, p, ragged_left, ragged_right)


def get_expectations(sm: StateMachine, hmm: Hmm, seq_x: str, seq_y: str,
                     p: PairwiseAlignmentParameters,
                     ragged_left: bool = False,
                     ragged_right: bool = False) -> None:
    anchors = get_anchors(seq_x, seq_y, p)
    get_expectations_using_anchors(
        sm, hmm, seq_x, seq_y, anchors, p, ragged_left, ragged_right)
