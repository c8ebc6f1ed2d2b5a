#!/usr/bin/env python
"""Benchmark harness for the five BASELINE.md configs.

Default (no args): the headline metric — pair-HMM DP cells/sec/chip on
banded ~1 kb pairs — printed as ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

`--all` measures every BASELINE.md config and prints one JSON report
(also written to BENCH_ALL.json); `--config NAME` runs a single config.

vs_baseline compares cell-throughput metrics against the measured
single-core C cell-update rate (native/bench_cells.c, the reference's
per-cell arithmetic with lookup-based logAdd), built on first use.
Metrics with no C comparator (the reference publishes no numbers,
BASELINE.md) report vs_baseline: null. DP cells are counted as in-band
(diagonal, slot) positions; each costs one forward and one backward
5-state update.
"""

import argparse
import io
import json
import os
import random
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cpecan_tpu.utils.jaxcache import enable_compilation_cache

enable_compilation_cache()

import jax
import jax.numpy as jnp

from cpecan_tpu.models.state_machine import state_machine5
from cpecan_tpu.ops import fb_batch
from cpecan_tpu.ops.band import construct_band, pad_band
from cpecan_tpu.utils.symbols import encode

HERE = os.path.dirname(os.path.abspath(__file__))
SEQ_LEN = 1000
BATCH = 256
EXPANSION = 20  # default diagonalExpansion


def measure_c_baseline() -> float:
    """Build + run the single-core C micro-benchmark; returns cells/s."""
    src = os.path.join(HERE, "native", "bench_cells.c")
    exe = os.path.join(HERE, "native", "bench_cells")
    try:
        if not os.path.exists(exe) or os.path.getmtime(exe) < os.path.getmtime(src):
            subprocess.run(["gcc", "-O3", "-o", exe, src, "-lm"], check=True,
                           capture_output=True)
        out = subprocess.run([exe], check=True, capture_output=True, text=True,
                             timeout=300)
        return float(out.stdout.split()[1])
    except Exception:
        return 5.0e6  # conservative single-core estimate if toolchain absent


def _random_pair(rng: np.random.Generator, n: int):
    """An evolved read pair: ~20% substitutions + short indels, the
    reference's test-data model (impl/randomSequences.c:50-73)."""
    import cpecan_tpu.utils.symbols as sym

    pyrng = random.Random(int(rng.integers(0, 2**31)))
    x = sym.get_random_sequence(n, pyrng).upper()
    y = sym.evolve_sequence(x, pyrng).upper()
    return x, y


def _time_reps(fn, reps: int, warmup: int = 1) -> float:
    """Median-of-reps wall time after warmup runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _metered_cells(fn) -> int:
    """dp_cells counted by the library's metrics during one run of fn.

    Used to derive the C comparator for end-to-end configs: the reference
    publishes no numbers (BASELINE.md), so estimated single-core C time =
    in-band cells / measured C cell rate (native/bench_cells.c runs the
    reference's per-cell fwd+bwd arithmetic). vs_baseline for latency
    metrics is then estimated-C-seconds / measured-seconds (speedup)."""
    from cpecan_tpu.utils import metrics

    metrics.reset()
    fn()
    return int(metrics.snapshot()["counters"].get("dp_cells", 0))


# ------------------------------------------------------------- headline

def build_batch(rng):
    """Banded ~1kb pairs: anchors every 50 bp on the identity diagonal with
    the default expansion (the anchored-banded benchmark config)."""
    from cpecan_tpu.align.pairwise import _width_bucket

    sxs, sys_, offs, wids, lxs, lys = [], [], [], [], [], []
    P = 2048
    W = None  # product-path width bucket of the band's frame (41 -> 41)
    cells = 0
    for _ in range(BATCH):
        seq = "".join("ACGT"[i] for i in rng.integers(0, 4, size=SEQ_LEN))
        anchors = [(i, i) for i in range(25, SEQ_LEN - 25, 50)]
        band = construct_band(anchors, SEQ_LEN, SEQ_LEN, EXPANSION)
        if W is None:
            W = _width_bucket(band.frame_width())
        o, w, L = pad_band(band, P, W)
        cells += int(band.widths.sum())
        sx = np.zeros(P, np.int32)
        sx[:SEQ_LEN] = encode(seq)
        sxs.append(sx)
        sys_.append(sx)
        offs.append(o)
        wids.append(w)
        lxs.append(SEQ_LEN)
        lys.append(SEQ_LEN)
    return (np.stack(sxs), np.stack(sys_), np.stack(offs), np.stack(wids),
            np.asarray(lxs, np.int32), np.asarray(lys, np.int32), W, cells)


def bench_headline(baseline: float) -> dict:
    """DP cells/s/chip on the fused banded FB posterior pass (B=256,
    1 kb anchored pairs)."""
    rng = np.random.default_rng(0)
    sx, sy, offsets, widths, lx, ly, W, cells = build_batch(rng)
    params = state_machine5().device_params()
    rl = np.zeros(BATCH, bool)
    rr = np.zeros(BATCH, bool)

    args = [jnp.asarray(a) for a in (sx, sy, offsets, widths, lx, ly, rl, rr)]

    def run():
        out = fb_batch.fb_pass_batch(params, *args, mode="posterior_match",
                                     width=W)
        return jnp.sum(out["post_match"])

    # force execution + host transfer; amortize the host round-trip by
    # forcing only the last of a pipelined run of reps
    float(run())  # compile + warm + sync
    reps = 10
    t0 = time.perf_counter()
    outs = [run() for _ in range(reps)]
    float(outs[-1])
    dt = (time.perf_counter() - t0) / reps

    cells_per_sec = cells / dt

    # companion: the dense-anchor (cigar-band) regime of realign/EM — one
    # anchor per matched base gives a narrow frame (the headline's 50 bp
    # anchor spacing interpolates to a wider one)
    from cpecan_tpu.align.pairwise import _width_bucket

    rng2 = np.random.default_rng(1)
    sxs, offs, wids = [], [], []
    P = 2048
    dense_cells = 0
    Wd = None
    for _ in range(BATCH):
        seq = "".join("ACGT"[i] for i in rng2.integers(0, 4, size=SEQ_LEN))
        anchors = [(i, i) for i in range(SEQ_LEN)]
        band = construct_band(anchors, SEQ_LEN, SEQ_LEN, EXPANSION)
        if Wd is None:
            Wd = _width_bucket(band.frame_width())
        o, w, L = pad_band(band, P, Wd)
        dense_cells += int(band.widths.sum())
        sx = np.zeros(P, np.int32)
        sx[:SEQ_LEN] = encode(seq)
        sxs.append(sx)
        offs.append(o)
        wids.append(w)
    dargs = [jnp.asarray(a) for a in
             (np.stack(sxs), np.stack(sxs), np.stack(offs), np.stack(wids),
              np.full(BATCH, SEQ_LEN, np.int32),
              np.full(BATCH, SEQ_LEN, np.int32), rl, rr)]

    def run_dense():
        out = fb_batch.fb_pass_batch(params, *dargs, mode="posterior_match",
                                     width=Wd)
        return jnp.sum(out["post_match"])

    float(run_dense())
    t0 = time.perf_counter()
    outs = [run_dense() for _ in range(reps)]
    float(outs[-1])
    dt_d = (time.perf_counter() - t0) / reps

    return {
        "metric": "pairhmm_dp_cells_per_sec_per_chip",
        "value": round(cells_per_sec),
        "unit": "cells/s",
        "vs_baseline": round(cells_per_sec / baseline, 2),
        "dense_band_cells_per_sec": round(dense_cells / dt_d),
        "dense_band_vs_baseline": round(dense_cells / dt_d / baseline, 2),
        "dense_band_width": Wd,
    }


# ------------------------------------- config 1: realign 1 kb latency

def bench_realign_1kb(baseline: float) -> dict:
    """End-to-end latency of the realign CLI on one ~1 kb record
    (BASELINE config #1): parse, anchor from the input cigar, band,
    banded FB posteriors, reweight, poset-consistency filter, cigar out.
    Also reports posterior parity between the active engine and the
    lax.scan oracle on the same pair."""
    import tempfile

    from cpecan_tpu.cli import realign as realign_cli
    from cpecan_tpu.io import cigar as cigar_io

    rng = np.random.default_rng(1)
    x, y = _random_pair(rng, SEQ_LEN)
    m = min(len(x), len(y))
    ops = [(cigar_io.MATCH, m)]
    if len(x) > m:
        ops.append((cigar_io.INDEL_X, len(x) - m))
    if len(y) > m:
        ops.append((cigar_io.INDEL_Y, len(y) - m))
    pa = cigar_io.PairwiseAlignment(
        "seqX", 0, len(x), True, "seqY", 0, len(y), True, 0.0, ops)
    text = cigar_io.cigar_format(pa) + "\n"

    with tempfile.TemporaryDirectory() as td:
        fasta = os.path.join(td, "seqs.fa")
        with open(fasta, "w") as fh:
            fh.write(f">seqX\n{x}\n>seqY\n{y}\n")

        def run():
            out = io.StringIO()
            rc = realign_cli.main([fasta], stdin=io.StringIO(text), stdout=out)
            assert rc == 0

        dt = _time_reps(run, reps=5, warmup=2)
        cells = _metered_cells(run)

    parity = _posterior_parity(x, y)
    return {
        "metric": "realign_1kb_latency",
        "value": round(dt, 4),
        "unit": "s",
        "vs_baseline": round(cells / baseline / dt, 2),
        "posterior_parity_max_abs": parity,
    }


def _posterior_parity(x: str, y: str) -> float:
    """Max |posterior| gap between the active engine and the scan oracle
    on one banded pair (fixed-point units of 1e7 = PAIR_ALIGNMENT_PROB_1,
    returned as a probability). The C logAdd lookup is itself ~1e-3
    approximate, which sets the parity bar (SURVEY.md hard part #2)."""
    from cpecan_tpu.align import pairwise
    from cpecan_tpu.config import PairwiseAlignmentParameters
    from cpecan_tpu.models.state_machine import state_machine5 as sm5

    sm = sm5()
    p = PairwiseAlignmentParameters()
    anchors = [(i, i) for i in range(25, min(len(x), len(y)) - 25, 50)]

    engines = {}
    for engine in ("auto", "scan"):
        os.environ["CPECAN_TPU_ENGINE"] = engine
        try:
            pairs = pairwise.get_aligned_pairs_using_anchors(
                sm, x, y, anchors, p)
        finally:
            del os.environ["CPECAN_TPU_ENGINE"]
        engines[engine] = {(int(r["x"]), int(r["y"])): int(r["prob"])
                           for r in pairs}
    keys = set(engines["auto"]) | set(engines["scan"])
    diff = max((abs(engines["auto"].get(k, 0) - engines["scan"].get(k, 0))
                for k in keys), default=0)
    return round(diff / 1e7, 6)


# --------------------------------- config 2: 1024 x 1 kb full-band pairs

def bench_read_pairs_1kb(baseline: float, n_pairs: int = 1024) -> dict:
    """Batched FB + posterior pair decoding of 1024 random ~1 kb evolved
    pairs, full band, single chip (BASELINE config #2), through the real
    end-to-end batch API (shape bucketing, device batching, sparse pair
    extraction)."""
    from cpecan_tpu.align import batch as batch_mod
    from cpecan_tpu.config import PairwiseAlignmentParameters
    from cpecan_tpu.models.state_machine import state_machine5 as sm5

    from cpecan_tpu.ops.band import full_band

    rng = np.random.default_rng(2)
    sm = sm5()
    # anchors=None: full-band jobs (whole rectangle, no splitting)
    p = PairwiseAlignmentParameters()
    jobs, cells = [], 0
    for _ in range(n_pairs):
        x, y = _random_pair(rng, SEQ_LEN)
        jobs.append((x, y, None, False, False))
        cells += int(full_band(len(x), len(y)).widths.sum())

    def run():
        batch_mod.batch_posteriors(sm, jobs, p, mode="posterior_match")

    dt = _time_reps(run, reps=3, warmup=1)
    return {
        "metric": "read_pairs_1kb_per_sec",
        "value": round(n_pairs / dt, 2),
        "unit": "pairs/s",
        "vs_baseline": round(cells / dt / baseline, 2),
        "dp_cells_per_sec": round(cells / dt),
        "vs_baseline_cells": round(cells / dt / baseline, 2),
    }


# ------------------------------------ config 3: anchored 10-50 kb pairs

def bench_anchored_50kb(baseline: float, n: int = 50_000,
                        reps: int = 3, genomic: bool = False) -> dict:
    """Anchored banded alignment of one 50 kb genomic-like pair end to end
    (BASELINE config #3): native k-mer seeding/chaining, recursion,
    large-gap splitting, bucketed device batches, pair extraction.
    The pair is planted-truth evolved (10% substitutions, 2% short
    indels — the anchored regime the config targets) so the bench also
    reports alignment sensitivity/specificity, the long-test metric."""
    from cpecan_tpu.align import pairwise
    from cpecan_tpu.config import PairwiseAlignmentParameters
    from cpecan_tpu.models.state_machine import state_machine5 as sm5
    from cpecan_tpu.msa.aligner import (
        filter_pairwise_alignment_to_make_pairs_ordered)
    from cpecan_tpu.ops import pairs as pairs_mod
    from cpecan_tpu.utils import metrics
    import cpecan_tpu.utils.symbols as sym

    pyrng = random.Random(3)
    if genomic:
        # soft-masked repeat-rich structure (~35% interspersed/tandem
        # repeats): the regime of the reference's ENCODE long test
        x = sym.genomic_like_sequence(n, pyrng)
        y, truth = sym.tracked_evolve(x, pyrng, sub_rate=0.08)
    else:
        x = "".join(pyrng.choice("ACGT") for _ in range(n))
        y, truth = sym.tracked_evolve(x, pyrng)
    sm = sm5()
    p = PairwiseAlignmentParameters()

    cells = [0]
    result = [None]

    def run():
        metrics.reset()
        pairs = pairwise.get_aligned_pairs(sm, x, y, p)
        cells[0] = metrics.snapshot()["counters"].get("dp_cells", 0)
        result[0] = pairs
        assert len(pairs) > 0

    dt = _time_reps(run, reps=reps, warmup=1)
    snap = metrics.snapshot()["stages"]
    host_s = (snap.get("host_anchoring", {}).get("seconds", 0.0)
              + snap.get("host_prep", {}).get("seconds", 0.0))

    ordered = filter_pairwise_alignment_to_make_pairs_ordered(
        pairs_mod.sort_pairs(result[0]), x, y, 0.9)
    truth_set = set(truth)
    pred = {(int(px), int(py)) for px, py in zip(ordered["x"], ordered["y"])}
    tp = len(pred & truth_set)
    return {
        "metric": "anchored_50kb_e2e",
        "value": round(dt, 3),
        "unit": "s",
        "vs_baseline": round(cells[0] / dt / baseline, 2),
        "dp_cells_per_sec": round(cells[0] / dt),
        "vs_baseline_cells": round(cells[0] / dt / baseline, 2),
        "host_prep_seconds": round(host_s, 3),
        "host_prep_fraction": round(host_s / max(dt, 1e-9), 4),
        "sensitivity": round(tp / max(len(truth_set), 1), 4),
        "specificity": round(tp / max(len(pred), 1), 4),
    }


# ------------------------------------------- config 4: EM iterations/s

def bench_em(baseline: float, n_pairs: int = 64) -> dict:
    """Baum-Welch EM iterations/s over a 64 x 1 kb corpus (BASELINE
    config #4): bucketed expectation batches on device (in-jit count
    reduction) + host M-step, the cPecanEm iteration loop."""
    from cpecan_tpu.config import PairwiseAlignmentParameters
    from cpecan_tpu.em import em as em_mod
    from cpecan_tpu.io import cigar as cigar_io
    from cpecan_tpu.models.hmm import Hmm, StateMachineType
    from cpecan_tpu.models.state_machine import state_machine_from_hmm

    rng = np.random.default_rng(4)
    sequences, cigars = {}, []
    for i in range(n_pairs):
        x, y = _random_pair(rng, SEQ_LEN)
        sequences[f"x{i}"] = x
        sequences[f"y{i}"] = y
        m = min(len(x), len(y))
        ops = [(cigar_io.MATCH, m)]
        if len(x) > m:
            ops.append((cigar_io.INDEL_X, len(x) - m))
        if len(y) > m:
            ops.append((cigar_io.INDEL_Y, len(y) - m))
        cigars.append(cigar_io.PairwiseAlignment(
            f"x{i}", 0, len(x), True, f"y{i}", 0, len(y), True, 0.0, ops))

    options = em_mod.EmOptions(iterations=1, trials=1)
    p = options.pairwise_params()
    tasks = em_mod.tasks_from_cigars(cigars, sequences, p)
    model = em_mod.make_initial_model(options, random.Random(0))

    def one_iteration(model: Hmm) -> Hmm:
        sm = state_machine_from_hmm(model)
        expectations = Hmm(model.type, pseudo_expectation=1e-12)
        em_mod.expectation_step(sm, tasks, p, expectations)
        return em_mod.maximisation_step(expectations, model, options)

    state = [model]

    def run():
        state[0] = one_iteration(state[0])

    dt = _time_reps(run, reps=3, warmup=1)
    cells = _metered_cells(run)
    return {
        "metric": "em_iterations_per_sec_64x1kb",
        "value": round(1.0 / dt, 3),
        "unit": "iters/s",
        "vs_baseline": round(cells / baseline / dt, 2),
        "dp_cells_per_iteration": cells,
    }


# -------------------------------- config 4b: EM data-parallel scaling

_EM_SCALING_RUN = """
import os, sys, time, json, random
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
    " --xla_force_host_platform_device_count=%(ndev)d").strip()
sys.path.insert(0, %(repo)r)
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from cpecan_tpu.utils.jaxcache import enable_compilation_cache
enable_compilation_cache()
from cpecan_tpu.config import PairwiseAlignmentParameters
from cpecan_tpu.em import em as em_mod
from cpecan_tpu.io import cigar as cigar_io
from cpecan_tpu.models.hmm import Hmm
from cpecan_tpu.models.state_machine import state_machine_from_hmm
import cpecan_tpu.utils.symbols as sym

assert jax.device_count() == %(ndev)d
rng = random.Random(4)
n_pairs, n = %(n_pairs)d, %(seq_len)d
sequences, cigars = {}, []
for i in range(n_pairs):
    x = sym.get_random_sequence(n, rng).upper()
    y = sym.evolve_sequence(x, rng).upper()
    sequences["x%%d" %% i] = x; sequences["y%%d" %% i] = y
    m = min(len(x), len(y))
    ops = [(cigar_io.MATCH, m)]
    if len(x) > m: ops.append((cigar_io.INDEL_X, len(x) - m))
    if len(y) > m: ops.append((cigar_io.INDEL_Y, len(y) - m))
    cigars.append(cigar_io.PairwiseAlignment(
        "x%%d" %% i, 0, len(x), True, "y%%d" %% i, 0, len(y), True, 0.0, ops))
options = em_mod.EmOptions(iterations=1, trials=1)
p = options.pairwise_params()
tasks = em_mod.tasks_from_cigars(cigars, sequences, p)
model = em_mod.make_initial_model(options, random.Random(0))
mesh = None
if %(ndev)d > 1:
    from cpecan_tpu.parallel.mesh import data_mesh
    mesh = data_mesh(%(ndev)d)
def one(model):
    sm = state_machine_from_hmm(model)
    ex = Hmm(model.type, pseudo_expectation=1e-12)
    em_mod.expectation_step(sm, tasks, p, ex, mesh=mesh)
    return em_mod.maximisation_step(ex, model, options)
model = one(model)  # warm/compile
reps = 3
t0 = time.perf_counter()
for _ in range(reps):
    model = one(model)
dt = (time.perf_counter() - t0) / reps
print("EMSCALE " + json.dumps({"iters_per_sec": 1.0 / dt}))
"""


def bench_em_scaling(baseline: float, n_pairs: int = 64,
                     seq_len: int = 1000) -> dict:
    """Data-parallel EM dispatch overhead on a virtual CPU mesh (BASELINE
    config #4 scaling axis). The same shard_map expectation-reduction
    code path runs on real multi-chip meshes; the virtual mesh CANNOT
    show hardware speedup (all 8 "devices" share the host's cores), so
    the reported ratio is the sharding overhead factor — 1.0 would mean
    free sharding; real-chip scaling is bounded below by this path's
    correctness (tests/test_multihost.py proves 2-process parity)."""
    points = {}
    for ndev in (1, 8):
        script = _EM_SCALING_RUN % {
            "ndev": ndev, "repo": HERE, "n_pairs": n_pairs,
            "seq_len": seq_len}
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        res = subprocess.run([sys.executable, "-c", script],
                             capture_output=True, text=True, timeout=1200,
                             env=env, cwd=HERE)
        if res.returncode != 0:
            points[str(ndev)] = {"error": res.stderr[-500:]}
            continue
        line = [l for l in res.stdout.splitlines() if l.startswith("EMSCALE ")]
        points[str(ndev)] = json.loads(line[-1][len("EMSCALE "):])
    overhead = None
    if "iters_per_sec" in points.get("1", {}) and \
            "iters_per_sec" in points.get("8", {}):
        # Per-iteration extra wall time of the 8-way-sharded step vs the
        # unsharded one on the SAME silicon: pure dispatch+collective
        # overhead (a virtual mesh cannot speed compute up, so a ratio
        # labelled "x" would read like negative hardware scaling).
        t1 = 1.0 / points["1"]["iters_per_sec"]
        t8 = 1.0 / points["8"]["iters_per_sec"]
        overhead = round(t8 / t1 - 1.0, 3)
    return {
        "metric": "em_scaling_virtual8_sharding_overhead",
        "value": overhead,
        "unit": "extra_time_fraction_per_iter",
        "vs_baseline": None,
        "points": points,
        "note": ("8-device virtual CPU mesh: measures the sharded "
                 "expectation-psum path's dispatch+collective overhead, "
                 "not hardware scaling (single-chip environment; "
                 "2-process parity proven in tests/test_multihost.py)"),
    }


# ------------------------------------------------- config 5: MSA

def bench_msa(baseline: float, n_seqs: int = 20, seq_len: int = 500,
              reps: int = 3) -> dict:
    """Progressive multiple alignment of evolved sequences (BASELINE
    config #5): spanning-tree pair selection, batched pairwise posteriors
    on device, host column merging. Reports the host-merge vs device-
    posterior time split from the metrics stages."""
    from cpecan_tpu.config import PairwiseAlignmentParameters
    from cpecan_tpu.models.state_machine import state_machine5 as sm5
    from cpecan_tpu.msa import aligner
    from cpecan_tpu.utils import metrics

    pyrng = random.Random(5)
    import cpecan_tpu.utils.symbols as sym

    root = sym.get_random_sequence(seq_len, pyrng).upper()
    frags = [aligner.SeqFrag(sym.evolve_sequence(root, pyrng).upper(), i, i + 1)
             for i in range(n_seqs)]
    sm = sm5()
    p = PairwiseAlignmentParameters()

    def run():
        ma = aligner.make_alignment(sm, frags, spanning_trees=2,
                                    max_pairs_to_consider=10_000_000,
                                    use_progressive_merging=True,
                                    match_gamma=0.0, p=p, seed=0)
        assert len(ma.column_list()) > 0

    dt = _time_reps(run, reps=reps, warmup=1)
    cells = _metered_cells(run)
    snap = metrics.snapshot()["stages"]
    fb_s = snap.get("fb_pass", {}).get("seconds", 0.0)
    merge_s = snap.get("msa_merge", {}).get("seconds", 0.0)
    return {
        "metric": f"msa_{n_seqs}x{seq_len}_e2e",
        "value": round(dt, 3),
        "unit": "s",
        "vs_baseline": round(cells / baseline / dt, 2),
        "pair_posterior_cells_per_sec": round(cells / dt),
        "device_posterior_seconds": round(fb_s, 3),
        "host_merge_seconds": round(merge_s, 3),
    }


# ------------------------------------ config 5b: MSA at BASELINE scale


def bench_msa_100x1kb(baseline: float) -> dict:
    """BASELINE config #5 at its stated scale: progressive multiple
    alignment of 100 x 1 kb sequences end to end (reference comparator:
    makeAlignment, impl/multipleAligner.c:887-939)."""
    return {**bench_msa(baseline, n_seqs=100, seq_len=1000, reps=1),
            }


# --------------------------- reference-scale long pair (ENCODE analog)


def bench_long_500kb(baseline: float, n: int = 500_000) -> dict:
    """Reference-scale integration run: one ~0.5 Mb evolved pair through
    the full anchored pipeline (the regime of the reference's long test,
    tests/pairwiseAlignerLongTest.c:40-121, which aligns ~0.5 Mb ENCODE
    pairs and logs wall-clock + sensitivity/specificity)."""
    return {**bench_anchored_50kb(baseline, n=n, reps=1, genomic=True),
            "metric": "long_500kb_e2e"}


CONFIGS = {
    "headline": bench_headline,
    "realign_1kb": bench_realign_1kb,
    "read_pairs_1kb": bench_read_pairs_1kb,
    "anchored_50kb": bench_anchored_50kb,
    "long_500kb": bench_long_500kb,
    "em": bench_em,
    "em_scaling": bench_em_scaling,
    "msa": bench_msa,
    "msa_100x1kb": bench_msa_100x1kb,
}

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true",
                    help="run every BASELINE.md config; one-line JSON report")
    ap.add_argument("--config", choices=sorted(CONFIGS),
                    help="run a single named config")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny problem sizes (fast correctness check of the "
                         "harness itself; numbers are meaningless)")
    ap.add_argument("--resume-log", metavar="PATH",
                    help="reuse per-config JSON progress lines from an "
                         "earlier (crashed/killed) run's log: configs "
                         "already recorded there are not re-run. Only "
                         "lines whose commit context matches are safe to "
                         "reuse — the caller is responsible for passing a "
                         "log produced by the same code.")
    args = ap.parse_args()

    baseline = measure_c_baseline()

    if not (args.all or args.config):
        print(json.dumps(bench_headline(baseline)))
        return

    smoke_kwargs = {
        "read_pairs_1kb": {"n_pairs": 8},
        "anchored_50kb": {"n": 5000},
        "long_500kb": {"n": 8000},
        "em": {"n_pairs": 4},
        "em_scaling": {"n_pairs": 4, "seq_len": 200},
        "msa": {"n_seqs": 6, "seq_len": 100},
    } if args.smoke else {}
    if args.smoke:
        smoke_kwargs["msa_100x1kb"] = {}
        CONFIGS["msa_100x1kb"] = lambda b: {
            **bench_msa(b, n_seqs=8, seq_len=120, reps=1)}
    if args.smoke:
        global BATCH
        BATCH = 8

    resumed = {}
    if args.resume_log:
        with open(args.resume_log) as fh:
            for line in fh:
                line = line.strip()
                if not (line.startswith("{") and '"name"' in line):
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("name") in CONFIGS and "metric" in rec:
                    resumed[rec["name"]] = rec

    names = [args.config] if args.config else list(CONFIGS)
    configs = []
    for name in names:
        if name in resumed:
            result = {**resumed[name], "resumed": True}
        else:
            result = CONFIGS[name](baseline, **smoke_kwargs.get(name, {}))
            result = {"name": name, **result}
        configs.append(result)
        print(json.dumps(result), file=sys.stderr)  # progress

    commit = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                            capture_output=True, text=True,
                            cwd=HERE).stdout.strip() or "unknown"
    report = {
        "backend": jax.default_backend(),
        "device_count": jax.device_count(),
        "c_baseline_cells_per_sec": baseline,
        "date": time.strftime("%Y-%m-%d"),
        "commit": commit,
        "configs": configs,
    }
    print(json.dumps(report))
    if args.smoke:
        return  # never persist smoke numbers
    if not args.config:
        with open(os.path.join(HERE, "BENCH_ALL.json"), "w") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")


if __name__ == "__main__":
    main()
