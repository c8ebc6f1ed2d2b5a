"""Parity: cross-pair batched posterior alignment vs the sequential API."""

import random

import numpy as np

from cpecan_tpu.align import batch as batch_mod
from cpecan_tpu.align.anchors import get_anchors
from cpecan_tpu.align.pairwise import (
    get_aligned_pairs_using_anchors, get_aligned_pairs_with_indels_using_anchors)
from cpecan_tpu.config import PairwiseAlignmentParameters
from cpecan_tpu.models.state_machine import state_machine5
from cpecan_tpu.utils.symbols import evolve_sequence, get_random_sequence


def _jobs(n_jobs=5, seed=3):
    rng = random.Random(seed)
    p = PairwiseAlignmentParameters()
    jobs = []
    for i in range(n_jobs):
        n = rng.randint(40, 300)
        sx = get_random_sequence(n, rng)
        sy = evolve_sequence(sx, rng)
        anchors = get_anchors(sx, sy, p)
        jobs.append((sx, sy, anchors, i % 2 == 0, i % 3 == 0))
    return jobs, p


def _assert_same_pairs(a, b):
    a = np.sort(a, order=["x", "y"])
    b = np.sort(b, order=["x", "y"])
    assert len(a) == len(b)
    np.testing.assert_array_equal(a["x"], b["x"])
    np.testing.assert_array_equal(a["y"], b["y"])
    np.testing.assert_allclose(a["prob"], b["prob"], rtol=2e-3, atol=30)


def test_batch_matches_sequential_posterior_match():
    jobs, p = _jobs()
    sm = state_machine5()
    got = batch_mod.get_aligned_pairs_batch(sm, jobs, p)
    for (sx, sy, anchors, rl, rr), pairs in zip(jobs, got):
        ref = get_aligned_pairs_using_anchors(sm, sx, sy, anchors, p, rl, rr)
        _assert_same_pairs(pairs, ref)


def test_batch_sharded_wavefront_matches_sequential(request):
    """Posterior batches sharded over the 8-device mesh, running the
    fused kernels per shard (interpreted here), must match the
    sequential API."""
    from cpecan_tpu.ops import fb_batch
    from cpecan_tpu.parallel.mesh import data_mesh

    jobs, p = _jobs(n_jobs=4, seed=7)
    sm = state_machine5()
    refs = [get_aligned_pairs_using_anchors(sm, sx, sy, anchors, p, rl, rr)
            for (sx, sy, anchors, rl, rr) in jobs]
    request.getfixturevalue("interpreted_kernels")
    got = batch_mod.get_aligned_pairs_batch(sm, jobs, p, mesh=data_mesh())
    assert fb_batch.LAST_ENGINE == "wavefront_sharded"
    for pairs, ref in zip(got, refs):
        _assert_same_pairs(pairs, ref)


def test_batch_matches_sequential_posterior_all():
    jobs, p = _jobs(n_jobs=3, seed=11)
    sm = state_machine5()
    got = batch_mod.get_aligned_pairs_with_indels_batch(sm, jobs, p)
    for (sx, sy, anchors, rl, rr), triple in zip(jobs, got):
        ref = get_aligned_pairs_with_indels_using_anchors(
            sm, sx, sy, anchors, p, rl, rr)
        for a, b in zip(triple, ref):
            _assert_same_pairs(a, b)


def test_launch_splitting_matches_single_launch(monkeypatch):
    """With a tiny dense-output budget the bucket loop splits into many
    device launches and flushes between them; results must be identical
    to the single-launch run."""
    import random as _random

    from cpecan_tpu.align import batch as batch_mod
    from cpecan_tpu.config import PairwiseAlignmentParameters
    from cpecan_tpu.models.state_machine import state_machine5
    from cpecan_tpu.utils.symbols import evolve_sequence, get_random_sequence

    rng = _random.Random(3)
    sm = state_machine5()
    p = PairwiseAlignmentParameters()
    jobs = []
    for _ in range(5):
        x = get_random_sequence(60, rng).upper()
        y = evolve_sequence(x, rng).upper()
        jobs.append((x, y, None, False, False))  # full band

    want = batch_mod.batch_posteriors(sm, jobs, p, mode="posterior_match")
    monkeypatch.setattr(batch_mod, "device_budget_bytes", lambda: 1 << 16)
    got = batch_mod.batch_posteriors(sm, jobs, p, mode="posterior_match")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.sort(g), np.sort(w))
