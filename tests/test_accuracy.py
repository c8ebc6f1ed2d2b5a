"""Integration accuracy harness: sensitivity/specificity on evolved pairs.

The reference's long test (tests/pairwiseAlignerLongTest.c:40-121) runs the
full aligner on ~0.5 Mb ENCODE pairs and logs sensitivity/specificity of
the predicted aligned pairs against curated alignments. Without bundled
genome data we plant the ground truth instead: sequences evolved with a
*tracked* mutation process whose true base-to-base alignment is known
exactly. Unlike the reference we assert the scores.
"""

import random

import numpy as np
import pytest

from cpecan_tpu.align.pairwise import get_aligned_pairs
from cpecan_tpu.config import PairwiseAlignmentParameters
from cpecan_tpu.models.state_machine import state_machine5
from cpecan_tpu.ops.mea import mea_alignment
from cpecan_tpu.align.pairwise import get_aligned_pairs_with_indels
from cpecan_tpu.msa.aligner import filter_pairwise_alignment_to_make_pairs_ordered
from cpecan_tpu.ops import pairs as pairs_mod


from cpecan_tpu.utils.symbols import tracked_evolve  # planted-truth generator


def _sens_spec(predicted, truth):
    truth_set = set(truth)
    pred_set = {(int(x), int(y)) for x, y in predicted}
    tp = len(pred_set & truth_set)
    sens = tp / max(len(truth_set), 1)
    spec = tp / max(len(pred_set), 1)
    return sens, spec


@pytest.mark.slow
def test_anchored_10kb_with_large_gap_splitting():
    """10-50 kb anchored regime (BASELINE config #3): a long evolved pair
    with a big unrelated middle region, so k-mer anchoring, recursive
    re-anchoring, large-gap SPLITTING and the bucketed batch policy all
    fire together (reference long-test analog,
    tests/pairwiseAlignerLongTest.c:40-121 — asserted here)."""
    from cpecan_tpu.align.anchors import get_anchors
    from cpecan_tpu.align.split import get_split_points

    rng = random.Random(5)
    n_flank = 5000
    n_mid = 4000
    flank_a = "".join(rng.choice("ACGT") for _ in range(n_flank))
    flank_b = "".join(rng.choice("ACGT") for _ in range(n_flank))
    mid_x = "".join(rng.choice("ACGT") for _ in range(n_mid))
    mid_y = "".join(rng.choice("ACGT") for _ in range(n_mid))  # unrelated

    ya, truth_a = tracked_evolve(flank_a, rng, sub_rate=0.05)
    yb, truth_b = tracked_evolve(flank_b, rng, sub_rate=0.05)
    seq_x = flank_a + mid_x + flank_b
    seq_y = ya + mid_y + yb
    truth = (truth_a
             + [(x + n_flank + n_mid, y + len(ya) + n_mid)
                for x, y in truth_b])

    sm = state_machine5()
    p = PairwiseAlignmentParameters()
    anchors = get_anchors(seq_x, seq_y, p)
    assert len(anchors) > 50  # anchoring found the flanks
    split_points = get_split_points(anchors, len(seq_x), len(seq_y),
                                    p.splitMatrixBiggerThanThis, False, False)
    assert len(split_points) >= 2  # the unrelated middle forced a split

    pairs = get_aligned_pairs(sm, seq_x, seq_y, p)
    ordered = filter_pairwise_alignment_to_make_pairs_ordered(
        pairs_mod.sort_pairs(pairs), seq_x, seq_y, 0.9)
    sens, spec = _sens_spec(zip(ordered["x"], ordered["y"]), truth)
    assert sens > 0.90, f"sensitivity {sens:.3f}"
    assert spec > 0.90, f"specificity {spec:.3f}"

    # the unrelated middle must not produce confident matches
    mid_pred = [(x, y) for x, y in zip(ordered["x"], ordered["y"])
                if n_flank + 500 < x < n_flank + n_mid - 500]
    assert len(mid_pred) < n_mid // 20


@pytest.mark.parametrize("seed", [0, 1])
def test_posterior_decode_recovers_planted_alignment(seed):
    rng = random.Random(seed)
    n = 600
    seq_x = "".join(rng.choice("ACGT") for _ in range(n))
    seq_y, truth = tracked_evolve(seq_x, rng)

    sm = state_machine5()
    p = PairwiseAlignmentParameters()
    pairs = get_aligned_pairs(sm, seq_x, seq_y, p)
    assert len(pairs) > 0

    # MEA decode on the thresholded posteriors
    matches, gap_x, gap_y = get_aligned_pairs_with_indels(sm, seq_x, seq_y, p)
    mea, _score = mea_alignment(pairs_mod.sort_pairs(matches), gap_x, gap_y,
                                len(seq_x), len(seq_y), p.gapGamma)
    sens, spec = _sens_spec(zip(mea["x"], mea["y"]), truth)
    assert sens > 0.90, f"MEA sensitivity {sens:.3f}"
    assert spec > 0.90, f"MEA specificity {spec:.3f}"

    # poset-consistency decode (the cPecanRealign default path)
    ordered = filter_pairwise_alignment_to_make_pairs_ordered(
        pairs_mod.sort_pairs(pairs), seq_x, seq_y, 0.9)
    sens2, spec2 = _sens_spec(zip(ordered["x"], ordered["y"]), truth)
    assert sens2 > 0.85, f"poset-filter sensitivity {sens2:.3f}"
    assert spec2 > 0.90, f"poset-filter specificity {spec2:.3f}"


@pytest.mark.slow
def test_long_pair_200kb_streaming_accuracy(monkeypatch):
    """Long-test analog at 200 kb (reference pairwiseAlignerLongTest.c
    runs ~0.5 Mb ENCODE pairs): a genomic-like planted pair long enough
    that the checkpointed streaming engine carries the banded FB in fixed
    memory — anchoring, banding, the streaming decision and the sparse
    posterior emission all fire together; sensitivity/specificity are
    asserted (the reference only logged them)."""
    from cpecan_tpu.ops import fb_streaming
    from cpecan_tpu.utils import metrics
    from cpecan_tpu.utils.symbols import tracked_evolve

    rng = random.Random(12)
    n = 200_000
    seq_x = "".join(rng.choice("ACGT") for _ in range(n))
    seq_y, truth = tracked_evolve(seq_x, rng)

    # a tight budget guarantees the streaming route even if defaults grow
    monkeypatch.setenv("CPECAN_TPU_STREAM_BUDGET", str(64 << 20))

    sm = state_machine5()
    p = PairwiseAlignmentParameters()
    metrics.reset()
    pairs = get_aligned_pairs(sm, seq_x, seq_y, p)
    assert metrics.snapshot()["counters"].get("streamed_chunks", 0) > 0

    ordered = filter_pairwise_alignment_to_make_pairs_ordered(
        pairs_mod.sort_pairs(pairs), seq_x, seq_y, 0.9)
    sens, spec = _sens_spec(zip(ordered["x"], ordered["y"]), truth)
    assert sens > 0.90, f"sensitivity {sens:.3f}"
    assert spec > 0.90, f"specificity {spec:.3f}"


@pytest.mark.slow
def test_long_repeat_rich_pair_accuracy():
    """Repeat-aware long-pair accuracy at ENCODE-like scale (reference
    pairwiseAlignerLongTest.c:40-121): a soft-masked repeat-rich
    genomic-like pair (interspersed SINE/LINE-like families ~35% by
    length, tandem repeats, GC-skewed unique segments) through the FULL
    pipeline — this is exactly the regime where k-mer anchoring can
    diverge from lastz (SURVEY hard-part 4).  Asserts sens/spec floors
    AND, when the C reference builds, that our posteriors score >= the
    reference engine fed the SAME anchors on the SAME input.

    Scale: 120 kb in the default suite (CPU minutes); 500 kb when
    CPECAN_TPU_LONGTEST=1 (the bench long_500kb config covers the full
    scale on the GPU)."""
    import os
    from cpecan_tpu.align.anchors import get_anchors
    from cpecan_tpu.align.pairwise import get_aligned_pairs_using_anchors
    from cpecan_tpu.utils.symbols import genomic_like_sequence

    n = 500_000 if os.environ.get("CPECAN_TPU_LONGTEST") else 120_000
    rng = random.Random(2024)
    seq_x = genomic_like_sequence(n, rng)
    seq_y, truth = tracked_evolve(seq_x, rng, sub_rate=0.08)

    sm = state_machine5()
    p = PairwiseAlignmentParameters()
    anchors = get_anchors(seq_x, seq_y, p)
    assert len(anchors) > n // 100  # anchoring survived the repeats

    pairs = get_aligned_pairs_using_anchors(sm, seq_x, seq_y, anchors, p)
    ordered = filter_pairwise_alignment_to_make_pairs_ordered(
        pairs_mod.sort_pairs(pairs), seq_x, seq_y, 0.9)
    sens, spec = _sens_spec(zip(ordered["x"], ordered["y"]), truth)
    assert sens > 0.85, f"sensitivity {sens:.3f}"
    assert spec > 0.95, f"specificity {spec:.3f}"

    # --- score the C reference engine on the same input + anchors ---
    try:
        from tests.test_ref_parity import _binary, run_ref, parse_ref_pairs
    except ImportError:
        from test_ref_parity import _binary, run_ref, parse_ref_pairs
    try:
        ref_bin = _binary()
    except Exception:
        return  # reference unavailable: floors above still asserted
    anchor_list = [(int(a), int(b), int(e)) for a, b, e in anchors]
    ref_pairs = parse_ref_pairs(
        run_ref(ref_bin, "pairs", "fiveState", seq_x, seq_y,
                anchors=anchor_list, threshold=0.01))
    truth_set = set(truth)
    CONF = 0.5  # compare confident posteriors engine-to-engine
    ref_conf = {k for k, v in ref_pairs.items() if v >= CONF}
    our_conf = {(int(q["x"]), int(q["y"])) for q in pairs
                if int(q["prob"]) >= CONF * 1e7}
    ref_sens = len(ref_conf & truth_set) / max(len(truth_set), 1)
    our_sens = len(our_conf & truth_set) / max(len(truth_set), 1)
    ref_spec = len(ref_conf & truth_set) / max(len(ref_conf), 1)
    our_spec = len(our_conf & truth_set) / max(len(our_conf), 1)
    assert our_sens >= ref_sens - 0.005, (our_sens, ref_sens)
    assert our_spec >= ref_spec - 0.005, (our_spec, ref_spec)
