"""Cross-pair batched posterior alignment.

The reference processes one cigar at a time through the banded engine
(cPecanRealign.c main loop). On an accelerator that leaves the device
idle between tiny launches, so here many pairs' band chunks are
flattened into shape-bucketed device batches: every chunk produced by
large-gap splitting (align/split.py) across *all* jobs becomes one row
of a (padded diagonals, padded width) bucket, each bucket runs through
fb_batch.fb_pass_batch once (the fused kernels on a GPU), and
posterior pairs scatter back to their jobs with the chunk coordinate
shifts. This is the read-pairs/sec path the CLIs use.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import jax.numpy as jnp

from cpecan_tpu.config import PairwiseAlignmentParameters
from cpecan_tpu.models.state_machine import StateMachine
from cpecan_tpu.align.pairwise import (
    _bucket, _iterate_chunks, _width_bucket)
from cpecan_tpu.ops import fb_batch, fb_streaming
from cpecan_tpu.ops.fb_streaming import device_budget_bytes
from cpecan_tpu.ops import pairs as pairs_mod
from cpecan_tpu.ops.band import construct_band, full_band, pad_band
from cpecan_tpu.utils import hostlink, metrics
from cpecan_tpu.utils.symbols import encode


@dataclasses.dataclass
class _Task:
    job: int
    x1: int
    y1: int
    sub_x: str
    sub_y: str
    anchors: list
    ragged_left: bool
    ragged_right: bool


@jax.jit
def _count_above(post, thr):
    """Per-launch entry count and per-row max (for capacity sizing and
    slot-overflow detection) — fetched in one batched round trip."""
    B, P1, W = post.shape
    hit = post >= thr
    rows = jnp.sum(hit, axis=-1)
    return jnp.sum(rows, dtype=jnp.int32), jnp.max(rows).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("cap", "exact"))
def _compact_above(post, thr, cap, exact=False):
    """Compact a launch's (B, P+1, W) posterior block to its >= thr
    entries on device (ops/compact.py) so only those cross the host
    link. Returns (idx, vals, ...) with idx flat over (B*(P+1), W)."""
    from cpecan_tpu.ops import compact

    B, P1, W = post.shape
    rows = post.reshape(B * P1, W)
    if exact:
        return compact.compact_rows_exact(rows, thr, cap)
    return compact.compact_rows(rows, thr, cap)


def _sparse_to_pairs_batch(idx, vals, offs, P1, W, items, res_one):
    """Vectorized host decode of one launch's compacted entries into
    per-job pair arrays (addPosteriorProb semantics)."""
    from cpecan_tpu.utils.logmath import PAIR_ALIGNMENT_PROB_1

    sel = idx >= 0
    idx = idx[sel].astype(np.int64)
    vals = vals[sel]
    rows = idx // W
    js = idx % W
    b = rows // P1
    ks = rows % P1
    # per-item frame offsets: vectorized cummax over the offsets matrix
    xoff = pairs_mod.frame_offsets_batch(offs)
    xs = xoff[b, ks] + js
    ys = ks - xs
    prob = np.floor(np.minimum(vals.astype(np.float64), 1.0)
                    * PAIR_ALIGNMENT_PROB_1).astype(np.int64)
    order = np.argsort(b, kind="stable")
    b, ks, xs, ys, prob = b[order], ks[order], xs[order], ys[order], prob[order]
    bounds = np.searchsorted(b, np.arange(len(items) + 1))
    for i, (t, band) in enumerate(items):
        lo, hi = bounds[i], bounds[i + 1]
        keep = ks[lo:hi] <= band.diagonal_number
        res_one[t.job].append(pairs_mod.make_pairs(
            prob[lo:hi][keep], xs[lo:hi][keep] - 1 + t.x1,
            ys[lo:hi][keep] - 1 + t.y1))


def _batch_bucket_size(n: int) -> int:
    """Pad batch sizes to powers of two (bounds the number of compiled
    shapes per (P, W) bucket)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _stream_entries_to_pairs(entries, xoff, L, ox, oy):
    """Streaming-engine sparse posterior entries -> pair array with the
    chunk coordinate shift (same fixed-point semantics as
    _sparse_to_pairs)."""
    from cpecan_tpu.utils.logmath import PAIR_ALIGNMENT_PROB_1

    vals, ks, js = entries
    keep = ks <= L
    vals, ks, js = vals[keep], ks[keep], js[keep]
    xs = xoff[ks] + js
    ys = ks - xs
    p = np.minimum(vals, 1.0)
    return pairs_mod.make_pairs(
        np.floor(p.astype(np.float64) * PAIR_ALIGNMENT_PROB_1).astype(np.int64),
        xs - 1 + ox, ys - 1 + oy)


def _run_streaming_task(params, t, band, p, mode, keys):
    """One long pair chunk through the checkpointed streaming engine
    (ops/fb_streaming.py) — fixed memory for arbitrarily long chunks."""
    W = _width_bucket(band.frame_width())
    out = fb_streaming.fb_pass_streaming(
        params, encode(t.sub_x), encode(t.sub_y), band.offsets, band.widths,
        len(t.sub_x), len(t.sub_y), t.ragged_left, t.ragged_right,
        mode, W, fb_streaming.window_rows(p), threshold=p.threshold)
    metrics.add("dp_cells", int(band.widths.sum()))
    metrics.add("streamed_chunks", 1)
    L = band.diagonal_number
    return [_stream_entries_to_pairs(out["post_entries"][k], out["xoff"],
                                     L, t.x1, t.y1)
            for k in keys]


def _expand_jobs(jobs, p):
    tasks = []
    for ji, (seq_x, seq_y, anchor_pairs, rl0, rr0) in enumerate(jobs):
        if anchor_pairs is None:
            # full-band job (the reference's unbanded small-matrix path):
            # whole rectangle, no splitting
            tasks.append(_Task(ji, 0, 0, seq_x, seq_y, None, rl0, rr0))
            continue
        for (x1, y1, x2, y2), local, rl, rr in _iterate_chunks(
                seq_x, seq_y, anchor_pairs, p, rl0, rr0):
            if x2 - x1 == 0 and y2 - y1 == 0:
                continue
            tasks.append(_Task(ji, x1, y1, seq_x[x1:x2], seq_y[y1:y2],
                               local, rl, rr))
    return tasks


def batch_posteriors(sm: StateMachine, jobs, p: PairwiseAlignmentParameters,
                     mode: str = "posterior_match", mesh=None):
    """Run all jobs' band chunks through shape-bucketed device batches.

    jobs: iterable of (seq_x, seq_y, anchor_pairs, ragged_left,
    ragged_right); anchor_pairs=None runs the job full-band (whole
    rectangle, no splitting). Returns, per job, the thresholded posterior pair
    array(s): one array in posterior_match mode, a (match, gap_x, gap_y)
    triple in posterior_all mode. With a mesh, each bucket's batch is
    padded to the device count and sharded over the "data" axis.
    """
    n_out = 3 if mode == "posterior_all" else 1
    keys = (("post_match", "post_gap_x", "post_gap_y")[:n_out])
    results = [[[] for _ in jobs] for _ in range(n_out)]

    with metrics.stage("host_prep"):
        tasks = _expand_jobs(jobs, p)
    params = sm.device_params()
    buckets: dict = {}
    for t in tasks:
        with metrics.stage("host_prep"):
            if t.anchors is None:
                band = full_band(len(t.sub_x), len(t.sub_y))
            else:
                arr = np.asarray(
                    t.anchors if isinstance(t.anchors, np.ndarray)
                    else list(t.anchors), dtype=np.int64)
                if arr.ndim == 1:
                    arr = arr.reshape(0, 3)
                if p.dynamicAnchorExpansion:
                    band = construct_band(arr, len(t.sub_x), len(t.sub_y),
                                          expansion=None)
                else:
                    band = construct_band(arr[:, :2], len(t.sub_x),
                                          len(t.sub_y), p.diagonalExpansion)
            W = _width_bucket(band.frame_width())
        if fb_streaming.should_stream(band.diagonal_number, W):
            # chunk too long for the two-pass engines: checkpointed
            # streaming in fixed memory (reference traceback windowing)
            for oi, pairs in enumerate(_run_streaming_task(
                    params, t, band, p, mode, keys)):
                results[oi][t.job].append(pairs)
            continue
        P = _bucket(band.diagonal_number)
        buckets.setdefault((P, W), []).append((t, band))

    # Launches enqueue without a single host sync; each flush cycle then
    # costs exactly two device->host round trips: one batched device_get
    # of all launches' entry counts, one of all tight-capacity
    # compactions.
    from cpecan_tpu.ops import compact as compact_mod

    n_dev = 1 if mesh is None else mesh.devices.size
    pending = []  # (items, offs (B, P+1), out, count_devs) per launch
    pending_bytes = 0

    def flush():
        """Count -> compact -> decode for everything queued: only the
        >= threshold entries ever cross the host link (the dense
        posteriors can be 100x larger)."""
        nonlocal pending, pending_bytes
        if not pending:
            return
        counts = hostlink.device_get_pipelined(
            [cd for (_i, _o, _out, cd) in pending])
        comp = []
        for (items, offs, out, _cd), cnts in zip(pending, counts):
            per_key = []
            for k, (count, row_max) in zip(keys, cnts):
                cap = _batch_bucket_size(max(int(count), 64))
                exact = int(row_max) > compact_mod.DEFAULT_SLOTS
                per_key.append(_compact_above(out[k], p.threshold,
                                              cap=cap, exact=exact))
            comp.append(per_key)
        fetched = hostlink.device_get_pipelined(comp)
        for (items, offs, out, _cd), per_key in zip(pending, fetched):
            Wp = out[keys[0]].shape[2]
            P1 = out[keys[0]].shape[1]
            for oi in range(n_out):
                idx, vals = per_key[oi][0], per_key[oi][1]
                _sparse_to_pairs_batch(idx, vals, offs, P1, Wp, items,
                                       results[oi])
        pending = []
        pending_bytes = 0

    # Dense posterior outputs live on device until sparsified; launches
    # are sized to the device budget (each pair holds its F and B rows
    # plus the dense outputs while it runs) and flushed so the bytes
    # queued stay bounded, while small buckets still pipeline.
    dense_budget = device_budget_bytes()
    S = sm.state_number

    with metrics.stage("fb_pass"):
        launches = []
        for (P, W), items in sorted(buckets.items()):
            per_pair = (P + 1) * W * 4 * (2 * S + n_out)
            bmax = max(1, int(dense_budget // per_pair))
            bmax = 1 << (bmax.bit_length() - 1)  # power of two: B == bmax
            bmax = max(bmax, n_dev)
            launches.extend(((P, W), items[s:s + bmax])
                            for s in range(0, len(items), bmax))
        for (P, W), items in launches:
            B = _batch_bucket_size(len(items))
            B = ((B + n_dev - 1) // n_dev) * n_dev
            sx = np.zeros((B, P), np.int32)
            sy = np.zeros((B, P), np.int32)
            offsets = np.zeros((B, P + 1), np.int32)
            offsets[:, 1::2] = 1  # parity-consistent pad rows
            widths = np.ones((B, P + 1), np.int32)
            lx = np.zeros(B, np.int32)
            ly = np.zeros(B, np.int32)
            rl = np.zeros(B, bool)
            rr = np.zeros(B, bool)
            for i, (t, band) in enumerate(items):
                o, w, L = pad_band(band, P)
                offsets[i] = o
                widths[i] = w
                sx[i, : len(t.sub_x)] = encode(t.sub_x)
                sy[i, : len(t.sub_y)] = encode(t.sub_y)
                lx[i] = len(t.sub_x)
                ly[i] = len(t.sub_y)
                rl[i] = t.ragged_left
                rr[i] = t.ragged_right

            metrics.add("dp_cells", int(widths[: len(items)].sum()))
            arrays = dict(sx=sx, sy=sy, offsets=offsets, widths=widths,
                          lx=lx, ly=ly, rl=rl, rr=rr)
            arrays = fb_batch.shard_batch(arrays, mesh)
            out = fb_batch.fb_pass_batch(
                params, jnp.asarray(arrays["sx"]), jnp.asarray(arrays["sy"]),
                jnp.asarray(arrays["offsets"]), jnp.asarray(arrays["widths"]),
                jnp.asarray(arrays["lx"]), jnp.asarray(arrays["ly"]),
                jnp.asarray(arrays["rl"]), jnp.asarray(arrays["rr"]),
                mode=mode, width=W, mesh=mesh)
            counts = [_count_above(out[k], p.threshold) for k in keys]
            pending.append((items, offsets.astype(np.int64), out, counts))
            pending_bytes += B * (P + 1) * W * 4 * n_out
            if pending_bytes >= dense_budget:
                flush()
        flush()

    merged = [[pairs_mod.concat_pairs(job_lists) for job_lists in res]
              for res in results]
    if mode == "posterior_match":
        return merged[0]
    return list(zip(*merged))


def get_aligned_pairs_batch(sm: StateMachine, jobs,
                            p: PairwiseAlignmentParameters, mesh=None):
    """Batched get_aligned_pairs_using_anchors over many jobs."""
    return batch_posteriors(sm, jobs, p, mode="posterior_match", mesh=mesh)


def get_aligned_pairs_with_indels_batch(sm: StateMachine, jobs,
                                        p: PairwiseAlignmentParameters,
                                        mesh=None):
    """Batched get_aligned_pairs_with_indels_using_anchors: per job a
    (match, gap_x, gap_y) pair-array triple."""
    return batch_posteriors(sm, jobs, p, mode="posterior_all", mesh=mesh)
