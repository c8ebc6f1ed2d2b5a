#!/usr/bin/env python
"""Proof that cpecan_tpu's main path runs on one NVIDIA GPU.

Drives the system through the entry points a user calls, in one process
(a second JAX process could not reserve the card's memory):

  1. realign  cli.realign over 200 cigar records between evolved
              genomic-like pairs (500 bp - 20 kb, heavy-tailed, both
              strands, default flags); 4 records' posteriors against the
              scan engine on the CPU.
  2. batch    fb_batch.fb_pass_batch on 256 evolved 1 kb pairs at
              expansion 20, all four modes, 5- and 3-state models; the
              GPU engine against the scan engine on the GPU (all pairs)
              and on the CPU (8 pairs).
  3. align    cli.align on one anchored 50 kb genomic-like pair, and the
              exact streaming engine against the dense pass of one 50 kb
              chunk.
  4. em       cli.em, 3 iterations over 64 x 1 kb pairs: likelihood must
              not decrease, the model must load.
  5. msa      msa.aligner.make_alignment on 20 x 500 bp.

Each phase prints one JSON line (name, seconds, engine, parity numbers);
any failure ends the script with a non-zero code. With `--multi` only
the EM expectation step runs, over 256 x 1 kb pairs on a 4-device data
mesh, against the same step on one device.

Tolerances (float32 engines, sums taken in different orders):
posteriors abs <= 1e-4; log-likelihood rel <= 1e-5; expectation counts
rel <= 1e-4 (1e-5 between the 4-device and 1-device runs, which share
one engine). Counts are compared entry by entry, relative to the entry,
for entries above 1e-6 of the largest count.

Usage:  python chip_smoke.py [--seed N] [--multi]
The last line of stdout is {"ok": true, "device": {...}}; on a machine
without a GPU the script exits non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import random
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np

POST_ABS = 1e-4
LOGLIK_REL = 1e-5
COUNT_REL = 1e-4
MULTI_COUNT_REL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, t0: float, **fields) -> None:
    from cpecan_tpu.ops import fb_batch

    print(json.dumps({"phase": phase,
                      "seconds": round(time.perf_counter() - t0, 3),
                      "engine": fb_batch.LAST_ENGINE, **fields}),
          flush=True)


# ----------------------------------------------------------------- data


def heavy_tailed_length(rng: random.Random, lo=500, hi=20_000) -> int:
    """Log-uniform, skewed to short: most records are short, a few long."""
    return int(lo * (hi / lo) ** (rng.random() ** 2))


def evolved_pair(rng: random.Random, n: int, genomic: bool = True):
    """(x, y, true aligned pairs): a genomic-like (or random) sequence and
    an evolved copy with substitutions and short indels."""
    from cpecan_tpu.utils.symbols import (
        genomic_like_sequence, get_random_sequence, tracked_evolve)

    x = (genomic_like_sequence(n, rng) if genomic
         else get_random_sequence(n, rng))
    y, pairs = tracked_evolve(x, rng)
    return x, y, pairs


def pairs_to_ops(pairs, lx: int, ly: int):
    """Cigar ops (M/D/I runs) of an alignment given by its aligned pairs;
    D consumes x, I consumes y."""
    from cpecan_tpu.io import cigar as cigar_io

    ops = []

    def add(op, n):
        if n <= 0:
            return
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + n)
        else:
            ops.append((op, n))

    px = py = 0
    for x, y in pairs:
        add(cigar_io.INDEL_X, x - px)
        add(cigar_io.INDEL_Y, y - py)
        add(cigar_io.MATCH, 1)
        px, py = x + 1, y + 1
    add(cigar_io.INDEL_X, lx - px)
    add(cigar_io.INDEL_Y, ly - py)
    return ops


def cigar_corpus(rng: random.Random, n_records: int, length_fn,
                 both_strands: bool, genomic: bool = True):
    """(sequences, cigar records) with one record per evolved pair; on a
    minus-strand record the query is stored reverse-complemented."""
    from cpecan_tpu.io import cigar as cigar_io
    from cpecan_tpu.utils.symbols import reverse_complement

    sequences, records = {}, []
    for i in range(n_records):
        x, y, pairs = evolved_pair(rng, length_fn(rng), genomic)
        plus = not both_strands or i % 2 == 0
        sequences[f"t{i}"] = x
        sequences[f"q{i}"] = y if plus else reverse_complement(y)
        start2, end2 = (0, len(y)) if plus else (len(y), 0)
        records.append(cigar_io.PairwiseAlignment(
            f"t{i}", 0, len(x), True, f"q{i}", start2, end2, plus, 0.0,
            pairs_to_ops(pairs, len(x), len(y))))
    return sequences, records


def write_fasta(path: str, sequences: dict) -> None:
    with open(path, "w") as fh:
        for name, seq in sequences.items():
            fh.write(f">{name}\n{seq}\n")


def write_cigars(path: str, records) -> None:
    from cpecan_tpu.io import cigar as cigar_io

    with open(path, "w") as fh:
        for pa in records:
            cigar_io.cigar_write(fh, pa)


def band_batch(items, P: int, W: int):
    """Padded (B, ...) engine arrays for (sub_x, sub_y, band, rl, rr)."""
    from cpecan_tpu.ops.band import pad_band
    from cpecan_tpu.utils.symbols import encode

    B = len(items)
    sx = np.zeros((B, P), np.int32)
    sy = np.zeros((B, P), np.int32)
    offs = np.zeros((B, P + 1), np.int32)
    wids = np.zeros((B, P + 1), np.int32)
    lx = np.zeros(B, np.int32)
    ly = np.zeros(B, np.int32)
    rl = np.zeros(B, bool)
    rr = np.zeros(B, bool)
    for i, (x, y, band, ragl, ragr) in enumerate(items):
        offs[i], wids[i], _ = pad_band(band, P, W)
        sx[i, :len(x)] = encode(x)
        sy[i, :len(y)] = encode(y)
        lx[i], ly[i], rl[i], rr[i] = len(x), len(y), ragl, ragr
    return (sx, sy, offs, wids, lx, ly, rl, rr)


# ------------------------------------------------------------ comparison


def loglik(out, lx, ly):
    """Per-pair global forward log-probability (host float64)."""
    mf = np.asarray(out["mf"], np.float64)
    lf = np.asarray(out["log_fwd"], np.float64)
    L = np.asarray(lx) + np.asarray(ly)
    return np.array([lf[i] + mf[i, :L[i] + 1].sum() for i in range(len(L))])


def rel_err(a, b, floor_frac: float = 0.0) -> float:
    """max |a - b| / |b| over entries with |b| above floor_frac * max|b|."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    keep = np.abs(b) > floor_frac * np.abs(b).max()
    if not keep.any():
        return 0.0
    return float(np.max(np.abs(a - b)[keep] / np.abs(b)[keep]))


def compare(got, ref, lx, ly, mode, rows=slice(None)):
    """Parity numbers of one engine output against a reference output."""
    res = {"loglik_rel": rel_err(loglik(got, lx, ly)[rows],
                                 loglik(ref, lx, ly)[rows])}
    posts = [k for k in ("post_match", "post_gap_x", "post_gap_y")
             if k in ref]
    if posts:
        res["post_abs"] = max(float(np.max(np.abs(
            np.asarray(got[k])[rows] - np.asarray(ref[k])[rows])))
            for k in posts)
    if mode == "expectation":
        res["count_rel"] = max(rel_err(got[k], ref[k], 1e-6)
                               for k in ("trans", "emis"))
    return res


def within(res: dict, count_rel: float = COUNT_REL) -> bool:
    return (res["loglik_rel"] <= LOGLIK_REL
            and res.get("post_abs", 0.0) <= POST_ABS
            and res.get("count_rel", 0.0) <= count_rel)


def on_cpu(arrays):
    import jax

    cpu = jax.devices("cpu")[0]
    return [jax.device_put(np.asarray(a), cpu) for a in arrays]


def scan_on_cpu(params, arrays, mode, W):
    """The scan engine (ops/fb.py) run on the host CPU device."""
    import jax

    from cpecan_tpu.ops import fb_batch

    cpu = jax.devices("cpu")[0]
    params = jax.device_put(params, cpu)
    with jax.default_device(cpu):
        return jax.device_get(fb_batch.fb_pass_batch_scan(
            params, *on_cpu(arrays), mode=mode, width=W))


# ---------------------------------------------------------------- phases


def phase_realign(rng, workdir, n_records=200, n_checked=4):
    import jax

    from cpecan_tpu.align.pairwise import _bucket, _width_bucket
    from cpecan_tpu.cli import realign
    from cpecan_tpu.config import PairwiseAlignmentParameters
    from cpecan_tpu.em import em as em_mod
    from cpecan_tpu.io import cigar as cigar_io
    from cpecan_tpu.models.state_machine import state_machine5
    from cpecan_tpu.ops import fb_batch
    from cpecan_tpu.ops.band import construct_band

    t0 = time.perf_counter()
    sequences, records = cigar_corpus(rng, n_records, heavy_tailed_length,
                                      both_strands=True)
    fa_t = os.path.join(workdir, "realign_target.fa")
    fa_q = os.path.join(workdir, "realign_query.fa")
    write_fasta(fa_t, {k: v for k, v in sequences.items() if k[0] == "t"})
    write_fasta(fa_q, {k: v for k, v in sequences.items() if k[0] == "q"})
    stdin = io.StringIO()
    for pa in records:
        cigar_io.cigar_write(stdin, pa)
    stdin.seek(0)
    out = io.StringIO()
    t_cli = time.perf_counter()
    check(realign.main([fa_t, fa_q], stdin=stdin, stdout=out) == 0,
          "realign exit code")
    cli_s = time.perf_counter() - t_cli
    engine = fb_batch.LAST_ENGINE
    got = list(cigar_io.cigar_read(io.StringIO(out.getvalue())))
    check(len(got) == len(records), f"realign wrote {len(got)} records")
    for a, b in zip(got, records):
        a.check()
        check((a.contig1, a.start1, a.end1, a.contig2, a.start2, a.end2)
              == (b.contig1, b.start1, b.end1, b.contig2, b.start2, b.end2),
              f"record {b.contig1} does not cover its input spans")

    # engine parity on the realign path's own chunks of a few records,
    # under the CLI's default parameters
    opts = realign.make_parser().parse_args([fa_t, fa_q])
    p = PairwiseAlignmentParameters(
        constraintDiagonalTrim=opts.constraintDiagonalTrim,
        diagonalExpansion=opts.diagonalExpansion, gapGamma=opts.gapGamma,
        splitMatrixBiggerThanThis=(opts.splitMatrixBiggerThanThis ** 2
                                   if opts.splitMatrixBiggerThanThis
                                   is not None else 10))
    order = sorted(range(n_records),
                   key=lambda i: records[i].end1 - records[i].start1)
    picked = [records[i] for i in order[:: max(1, n_records // n_checked)]
              [:n_checked]]
    tasks = em_mod.tasks_from_cigars(picked, sequences, p)
    sm = state_machine5()
    params = sm.device_params()
    buckets = {}
    for t in tasks:
        band = construct_band([(a[0], a[1]) for a in t.anchors],
                              len(t.sub_x), len(t.sub_y),
                              p.diagonalExpansion)
        key = (_bucket(band.diagonal_number),
               _width_bucket(band.frame_width()))
        buckets.setdefault(key, []).append(
            (t.sub_x, t.sub_y, band, t.ragged_left, t.ragged_right))
    worst = {"loglik_rel": 0.0, "post_abs": 0.0}
    for (P, W), items in buckets.items():
        arrays = band_batch(items, P, W)
        dev = fb_batch.fb_pass_batch(params, *arrays,
                                     mode="posterior_match", width=W)
        ref = scan_on_cpu(params, arrays, "posterior_match", W)
        res = compare(jax.device_get(dev), ref, arrays[4], arrays[5],
                      "posterior_match")
        worst = {k: max(worst[k], res[k]) for k in worst}
    check(within(worst), f"realign parity {worst}")
    lengths = [r.end1 - r.start1 for r in records]
    emit("realign", t0, cli_seconds=round(cli_s, 3), cli_engine=engine,
         records=len(got), bases=int(sum(lengths)),
         max_length=int(max(lengths)), checked_records=len(picked),
         checked_chunks=len(tasks), **worst)


def headline_batch(rng, B=256, n=1000, expansion=20):
    """B evolved 1 kb pairs, anchored on their true alignment (every 10th
    aligned pair, as a cigar's match runs would anchor them)."""
    from cpecan_tpu.align.pairwise import _bucket, _width_bucket
    from cpecan_tpu.ops.band import construct_band

    items = []
    for _ in range(B):
        x, y, pairs = evolved_pair(rng, n, genomic=False)
        band = construct_band(pairs[5::10], len(x), len(y), expansion)
        items.append((x, y, band, False, False))
    P = _bucket(max(it[2].diagonal_number for it in items))
    W = _width_bucket(max(it[2].frame_width() for it in items))
    return items, P, W


def phase_batch(rng, B=256, n_cpu=8):
    import jax

    from cpecan_tpu.models.state_machine import state_machine3, state_machine5
    from cpecan_tpu.ops import fb_batch

    t0 = time.perf_counter()
    items, P, W = headline_batch(rng, B)
    arrays = band_batch(items, P, W)
    lx, ly = arrays[4], arrays[5]
    results = {}
    engines = set()
    for sm_name, factory in (("five", state_machine5),
                             ("three", state_machine3)):
        params = factory().device_params()
        for mode in ("forward", "posterior_match", "posterior_all",
                     "expectation"):
            got = jax.device_get(fb_batch.fb_pass_batch(params, *arrays, mode=mode,
                                                 width=W))
            engines.add(fb_batch.LAST_ENGINE)
            ref = jax.device_get(fb_batch.fb_pass_batch(params, *arrays, mode=mode,
                                                 width=W, engine="scan"))
            vs_gpu = compare(got, ref, lx, ly, mode)
            small = [a[:n_cpu] for a in arrays]
            got_s = jax.device_get(fb_batch.fb_pass_batch(params, *small, mode=mode,
                                                   width=W))
            ref_s = scan_on_cpu(params, small, mode, W)
            vs_cpu = compare(got_s, ref_s, lx[:n_cpu], ly[:n_cpu], mode)
            check(within(vs_gpu) and within(vs_cpu),
                  f"batch parity {sm_name}/{mode}: {vs_gpu} {vs_cpu}")
            results[f"{sm_name}_{mode}"] = {"vs_gpu_scan": vs_gpu,
                                            "vs_cpu_scan": vs_cpu}
    emit("batch", t0, pairs=B, rows=P + 1, width=W,
         engines=sorted(engines), parity=results)


def phase_align(rng, workdir, n=50_000):
    import jax

    from cpecan_tpu.align.anchors import get_anchors
    from cpecan_tpu.align.pairwise import _bucket, _width_bucket
    from cpecan_tpu.cli import align
    from cpecan_tpu.config import PairwiseAlignmentParameters
    from cpecan_tpu.io import cigar as cigar_io
    from cpecan_tpu.models.state_machine import state_machine5
    from cpecan_tpu.ops import fb_batch, fb_streaming
    from cpecan_tpu.ops.band import construct_band
    from cpecan_tpu.utils.symbols import encode

    t0 = time.perf_counter()
    x, y, _ = evolved_pair(rng, n)
    fa_t = os.path.join(workdir, "align_target.fa")
    fa_q = os.path.join(workdir, "align_query.fa")
    write_fasta(fa_t, {"target": x})
    write_fasta(fa_q, {"query": y})
    out = io.StringIO()
    t_cli = time.perf_counter()
    check(align.main([fa_t, fa_q], stdout=out) == 0, "align exit code")
    cli_s = time.perf_counter() - t_cli
    engine = fb_batch.LAST_ENGINE
    got = list(cigar_io.cigar_read(io.StringIO(out.getvalue())))
    check(len(got) == 1, f"align wrote {len(got)} records")
    got[0].check()
    check((got[0].end1 - got[0].start1, got[0].end2 - got[0].start2)
          == (len(x), len(y)), "align record does not span the pair")
    aligned = sum(k for op, k in got[0].operations if op == cigar_io.MATCH)

    # exact streaming vs the dense pass of one 50 kb chunk
    p = PairwiseAlignmentParameters()
    anchors = [(a[0], a[1]) for a in get_anchors(x, y, p)]
    band = construct_band(anchors, len(x), len(y), p.diagonalExpansion)
    W = _width_bucket(band.frame_width())
    P = _bucket(band.diagonal_number)
    params = state_machine5().device_params()
    arrays = band_batch([(x, y, band, False, False)], P, W)
    t_dense = time.perf_counter()
    dense = jax.device_get(fb_batch.fb_pass_batch(params, *arrays,
                                           mode="posterior_match", width=W))
    dense_s = time.perf_counter() - t_dense
    dense_engine = fb_batch.LAST_ENGINE
    t_stream = time.perf_counter()
    stream = fb_streaming.fb_pass_streaming(
        params, encode(x), encode(y), band.offsets, band.widths, len(x),
        len(y), False, False, "posterior_match", W,
        fb_streaming.window_rows(p), threshold=0.0)
    stream_s = time.perf_counter() - t_stream
    L = band.diagonal_number
    vals, ks, js = stream["post_entries"]["post_match"]
    sparse = np.zeros_like(dense["post_match"][0])
    sparse[ks, js] = vals
    # the streaming engine emits entries >= 1e-9 when threshold is 0
    dense_post = np.where(dense["post_match"][0] >= 1e-9,
                          dense["post_match"][0], 0.0)
    post_abs = float(np.max(np.abs(sparse[:L + 1] - dense_post[:L + 1])))
    ll_dense = float(loglik(dense, arrays[4], arrays[5])[0])
    ll_stream = float(stream["log_fwd"] + np.sum(stream["mf"][:L + 1]))
    ll_rel = abs(ll_stream - ll_dense) / abs(ll_dense)
    check(post_abs <= POST_ABS and ll_rel <= LOGLIK_REL,
          f"streaming vs dense: post_abs {post_abs} loglik_rel {ll_rel}")
    emit("align", t0, cli_seconds=round(cli_s, 3), cli_engine=engine,
         length_x=len(x), length_y=len(y), aligned_matches=int(aligned),
         chunk_rows=L + 1, chunk_width=W, windows=stream["windows"],
         dense_engine=dense_engine, dense_seconds=round(dense_s, 3),
         stream_seconds=round(stream_s, 3), post_abs=post_abs,
         loglik_rel=ll_rel)


def phase_em(rng, workdir, n_pairs=64, n=1000, iterations=3):
    from cpecan_tpu.cli import em
    from cpecan_tpu.models.hmm import Hmm

    t0 = time.perf_counter()
    sequences, records = cigar_corpus(rng, n_pairs, lambda r: n,
                                      both_strands=False, genomic=False)
    fa = os.path.join(workdir, "em.fa")
    cig = os.path.join(workdir, "em.cigar")
    model = os.path.join(workdir, "em.hmm")
    xml = os.path.join(workdir, "em.xml")
    write_fasta(fa, sequences)
    write_cigars(cig, records)
    check(em.main(["--sequences", fa, "--alignments", cig,
                   "--outputModel", model, "--iterations", str(iterations),
                   "--outputXMLModelFile", xml]) == 0, "em exit code")
    running = [float(v) for v in ET.parse(xml).getroot().find("hmm")
               .attrib["runningLikelihoods"].split("\t")]
    check(len(running) == iterations, f"running likelihoods {running}")
    worst_drop = max([running[i] - running[i + 1]
                      for i in range(len(running) - 1)] + [0.0])
    check(worst_drop <= LOGLIK_REL * abs(running[0]),
          f"EM log-likelihood decreased: {running}")
    hmm = Hmm.load(model)
    check(hmm.state_number == 5 and np.all(np.isfinite(hmm.transitions)),
          "EM model does not load")
    emit("em", t0, pairs=n_pairs, iterations=iterations,
         running_loglik=running)


def phase_msa(rng, n_seqs=20, n=500):
    from cpecan_tpu.config import PairwiseAlignmentParameters
    from cpecan_tpu.models.state_machine import state_machine5
    from cpecan_tpu.msa import aligner
    from cpecan_tpu.utils.symbols import evolve_sequence, get_random_sequence

    t0 = time.perf_counter()
    root = get_random_sequence(n, rng).upper()
    frags = [aligner.SeqFrag(evolve_sequence(root, rng).upper(), i, i + 1)
             for i in range(n_seqs)]
    ma = aligner.make_alignment(
        state_machine5(), frags, spanning_trees=2,
        max_pairs_to_consider=10_000_000, use_progressive_merging=True,
        match_gamma=0.0, p=PairwiseAlignmentParameters(), seed=0)
    cols = ma.column_list()
    seen = [pos for col in cols for pos in col]
    expect = {(s, i) for s, f in enumerate(frags) for i in range(f.length)}
    check(len(seen) == len(set(seen)) and set(seen) == expect,
          "MSA columns do not partition the sequences' positions")
    multi = sum(1 for c in cols if len(c) > 1)
    emit("msa", t0, sequences=n_seqs, columns=len(cols),
         aligned_columns=multi)


def phase_multi(rng, n_dev=4, n_pairs=256, n=1000):
    """EM expectation step on a data mesh of n_dev devices vs one device."""
    import jax

    from cpecan_tpu.config import PairwiseAlignmentParameters
    from cpecan_tpu.em import em as em_mod
    from cpecan_tpu.models.hmm import Hmm, StateMachineType
    from cpecan_tpu.models.state_machine import state_machine5
    from cpecan_tpu.ops import fb_batch
    from cpecan_tpu.parallel.mesh import data_mesh

    t0 = time.perf_counter()
    check(len(jax.devices()) >= n_dev, f"--multi needs {n_dev} devices")
    sequences, records = cigar_corpus(rng, n_pairs, lambda r: n,
                                      both_strands=False, genomic=False)
    p = PairwiseAlignmentParameters(constraintDiagonalTrim=0)
    tasks = em_mod.tasks_from_cigars(records, sequences, p)
    sm = state_machine5()
    runs = {}
    for label, mesh in (("one", None), ("mesh", data_mesh(n_dev)),
                        ("one_again", None), ("mesh_again",
                                              data_mesh(n_dev))):
        hmm = Hmm(StateMachineType.fiveState)
        ts = time.perf_counter()
        em_mod.expectation_step(sm, tasks, p, hmm, mesh=mesh)
        runs[label] = (hmm, time.perf_counter() - ts, fb_batch.LAST_ENGINE)
    one, mesh_hmm = runs["one"][0], runs["mesh"][0]
    count_rel = max(rel_err(mesh_hmm.transitions, one.transitions, 1e-6),
                    rel_err(mesh_hmm.emissions, one.emissions, 1e-6))
    ll_rel = abs(mesh_hmm.likelihood - one.likelihood) / abs(one.likelihood)
    check(count_rel <= MULTI_COUNT_REL and ll_rel <= LOGLIK_REL,
          f"mesh vs one device: count_rel {count_rel} loglik_rel {ll_rel}")
    # every mesh device held a shard (none of the work sits on device 0)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()[:n_dev]]
    check(all(pk is None or pk > 0 for pk in peaks),
          f"a mesh device did no work: {peaks}")
    emit("multi", t0, devices=n_dev, pairs=n_pairs,
         engine_one=runs["one"][2], engine_mesh=runs["mesh"][2],
         seconds_one=round(runs["one_again"][1], 3),
         seconds_mesh=round(runs["mesh_again"][1], 3),
         count_rel=count_rel, loglik_rel=ll_rel, peak_bytes=peaks)


# ------------------------------------------------------------------ main


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-device EM expectation phase")
    args = ap.parse_args(argv)

    from cpecan_tpu.utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform!r})",
              file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    rng = random.Random(args.seed)
    try:
        if args.multi:
            phase_multi(rng)
        else:
            with tempfile.TemporaryDirectory(dir=os.getcwd()) as workdir:
                phase_realign(rng, workdir)
                phase_batch(rng)
                phase_align(rng, workdir)
                phase_em(rng, workdir)
                phase_msa(rng)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
