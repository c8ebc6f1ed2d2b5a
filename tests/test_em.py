"""EM training tests: the likelihood-ratchet property (reference
tests/pairwiseAlignerTest.c:1091-1155 and cPecanEmTest.py:21-61), trials,
XML/blast-matrix outputs, and the data-parallel expectation reduction on a
multi-device mesh."""

import io
import os
import random

import numpy as np
import pytest

from cpecan_tpu.config import PairwiseAlignmentParameters
from cpecan_tpu.em import em as em_mod
from cpecan_tpu.em.em import EmOptions
from cpecan_tpu.io import cigar as cigar_io
from cpecan_tpu.models.hmm import Hmm, StateMachineType
from cpecan_tpu.utils.symbols import get_random_sequence, evolve_sequence


def make_corpus(n_pairs=6, length=50, seed=0):
    rng = random.Random(seed)
    sequences = {}
    cigars = []
    for i in range(n_pairs):
        x = "".join(rng.choice("ACGT") for _ in range(length))
        y = evolve_sequence(x, rng).upper() or "ACGT"
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
    return sequences, cigars


@pytest.mark.parametrize("model_type", ["fiveState", "threeState",
                                        "threeStateAsymmetric"])
def test_em_likelihood_ratchet(model_type, tmp_path):
    """Likelihood must not decrease across 10 EM iterations from a random
    start over 100 random evolved pairs (x0.95 slack) — the reference bar
    (tests/pairwiseAlignerTest.c:1091-1155: 10 iterations x 3 model types
    x 100 pairs).  ~20 s per model via the batched expectation path."""
    sequences, cigars = make_corpus(100, 60, seed=1)
    out_model = str(tmp_path / "hmm.txt")
    options = EmOptions(
        modelType=model_type, iterations=10, trials=1, randomStart=True,
        trainEmissions=True, seed=7,
        diagonalExpansion=4, splitMatrixBiggerThanThis=100 * 100)
    hmm = em_mod.expectation_maximisation(sequences, cigars, out_model, options)
    lk = hmm.running_likelihoods
    assert len(lk) == 10
    for a, b in zip(lk, lk[1:]):
        # likelihoods are large negative numbers; allow slack as reference
        assert b >= a - 0.05 * abs(a), lk


def test_em_checkpoint_file_roundtrip(tmp_path):
    sequences, cigars = make_corpus(2, 30, seed=2)
    out_model = str(tmp_path / "hmm.txt")
    options = EmOptions(modelType="fiveState", iterations=2, trials=1,
                        randomStart=True, trainEmissions=True,
                        diagonalExpansion=4,
                        splitMatrixBiggerThanThis=100 * 100)
    hmm = em_mod.expectation_maximisation(sequences, cigars, out_model, options)
    loaded = Hmm.load(out_model)
    np.testing.assert_allclose(loaded.transitions, hmm.transitions, rtol=1e-12)
    np.testing.assert_allclose(loaded.emissions, hmm.emissions, rtol=1e-12)
    assert loaded.running_likelihoods == pytest.approx(hmm.running_likelihoods)
    # model rows are normalised probability distributions
    np.testing.assert_allclose(loaded.transitions.sum(axis=1), 1.0, atol=1e-9)


def test_em_trials_and_reports(tmp_path):
    sequences, cigars = make_corpus(2, 30, seed=3)
    out_model = str(tmp_path / "hmm.txt")
    xml_file = str(tmp_path / "hmm.xml")
    blast_file = str(tmp_path / "matrix.txt")
    options = EmOptions(
        modelType="fiveState", iterations=2, trials=2, randomStart=True,
        trainEmissions=True, outputXMLModelFile=xml_file,
        blastScoringMatrixFile=blast_file, diagonalExpansion=4,
        splitMatrixBiggerThanThis=100 * 100)
    hmm = em_mod.expectation_maximisation_trials(
        sequences, cigars, out_model, options)
    assert os.path.exists(out_model)
    # XML summary parses and has the expected structure
    import xml.etree.ElementTree as ET
    root = ET.parse(xml_file).getroot()
    assert root.tag == "hmms"
    assert len(root.findall("hmm")) == 2
    assert root.attrib["maxLikelihood"] == str(hmm.likelihood)
    # blast matrix has the lastz-format header lines
    content = open(blast_file).read()
    assert "gap_open_penalty" in content and "gap_extend_penalty" in content
    lines = content.strip().split("\n")
    assert len(lines) == 7  # 2 penalties + header + 4 base rows


def test_em_keep_emissions_when_not_training(tmp_path):
    sequences, cigars = make_corpus(2, 30, seed=4)
    out_model = str(tmp_path / "hmm.txt")
    options = EmOptions(modelType="fiveState", iterations=2, trials=1,
                        randomStart=True, trainEmissions=False,
                        diagonalExpansion=4,
                        splitMatrixBiggerThanThis=100 * 100, seed=5)
    rng = random.Random(5)
    initial = em_mod.make_initial_model(options, rng)
    hmm = em_mod.expectation_maximisation(sequences, cigars, out_model, options)
    np.testing.assert_allclose(hmm.emissions, initial.emissions, atol=1e-9)


def test_expectation_step_data_parallel_matches_serial(request):
    """The sharded-mesh expectation reduction must equal the single-device
    result — same collectives code path as real multiple devices."""
    from cpecan_tpu.parallel.mesh import data_mesh
    from cpecan_tpu.models.state_machine import state_machine5

    sequences, cigars = make_corpus(5, 30, seed=6)
    p = PairwiseAlignmentParameters(
        constraintDiagonalTrim=0, diagonalExpansion=4,
        splitMatrixBiggerThanThis=100 * 100)
    sm = state_machine5()
    tasks = em_mod.tasks_from_cigars(cigars, sequences, p)
    assert tasks

    serial = Hmm(StateMachineType.fiveState)
    em_mod.expectation_step(sm, tasks, p, serial, mesh=None)

    mesh = data_mesh()
    assert mesh.devices.size == 8  # virtual CPU mesh from conftest
    parallel = Hmm(StateMachineType.fiveState)
    em_mod.expectation_step(sm, tasks, p, parallel, mesh=mesh)

    np.testing.assert_allclose(parallel.transitions, serial.transitions, rtol=1e-4)
    np.testing.assert_allclose(parallel.emissions, serial.emissions, rtol=1e-4)
    assert parallel.likelihood == pytest.approx(serial.likelihood, rel=1e-5)

    # the sharded path must also run the fused kernels (the GPU
    # configuration; interpreted here) with the same counts
    from cpecan_tpu.ops import fb_batch
    request.getfixturevalue("interpreted_kernels")
    wavefront = Hmm(StateMachineType.fiveState)
    em_mod.expectation_step(sm, tasks, p, wavefront, mesh=mesh,
                            engine="wavefront")
    assert fb_batch.LAST_ENGINE == "wavefront_sharded"
    np.testing.assert_allclose(wavefront.transitions, serial.transitions, rtol=1e-4)
    np.testing.assert_allclose(wavefront.emissions, serial.emissions, rtol=1e-4)
    assert wavefront.likelihood == pytest.approx(serial.likelihood, rel=1e-5)


def test_em_cli(tmp_path):
    from cpecan_tpu.cli import em as em_cli

    sequences, cigars = make_corpus(2, 25, seed=8)
    fasta = tmp_path / "seqs.fa"
    with open(fasta, "w") as fh:
        for name, seq in sequences.items():
            fh.write(f">{name}\n{seq}\n")
    cigar_file = tmp_path / "aln.cigar"
    with open(cigar_file, "w") as fh:
        for pa in cigars:
            cigar_io.cigar_write(fh, pa)
    out_model = str(tmp_path / "hmm.txt")
    rc = em_cli.main([
        "--sequences", str(fasta), "--alignments", str(cigar_file),
        "--outputModel", out_model, "--iterations", "2", "--trials", "1",
        "--randomStart", "--trainEmissions",
        "--diagonalExpansion", "4", "--splitMatrixBiggerThanThis", "100"])
    assert rc == 0
    hmm = Hmm.load(out_model)
    assert hmm.state_number == 5


def test_modify_hmm(tmp_path):
    from cpecan_tpu.cli import modify_hmm as mh_cli

    rng = np.random.default_rng(0)
    hmm = Hmm(StateMachineType.fiveState)
    hmm.randomise(rng)
    in_file = str(tmp_path / "in.hmm")
    out_file = str(tmp_path / "out.hmm")
    hmm.save(in_file, precise=True)
    rc = mh_cli.main([in_file, out_file, "--gcContent", "0.6",
                      "--substitutionRate", "0.1", "--setFlatIndelEmissions"])
    assert rc == 0
    out = Hmm.load(out_file)
    # flat indel emissions
    for s in range(1, 5):
        np.testing.assert_allclose(out.emissions[s], 1.0 / 16.0)
    # match-state reference-base marginals reflect GC target after the
    # gc normalisation followed by substitution convolution (row sums keep)
    row_marginals = out.emissions[0].sum(axis=1)
    np.testing.assert_allclose(row_marginals, [0.2, 0.3, 0.3, 0.2], atol=1e-9)


def test_em_retries_transient_chunk_failure(tmp_path, monkeypatch):
    """A transient device failure in one expectation chunk is retried
    (the jobTree retried-Target analog) and the trained model matches the
    failure-free run exactly — the scratch accumulator guarantees no
    double counting."""
    sequences, cigars = make_corpus(4, 40, seed=3)
    options = EmOptions(modelType="fiveState", iterations=2, trials=1,
                        trainEmissions=True, retryCount=2, seed=5)

    clean = em_mod.expectation_maximisation(
        sequences, cigars, str(tmp_path / "clean.txt"), options)

    calls = {"n": 0}
    real = em_mod.expectation_step

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected transient device failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(em_mod, "expectation_step", flaky)
    monkeypatch.setattr("cpecan_tpu.utils.retry.time",
                        type("T", (), {"sleep": staticmethod(lambda s: None)}))
    flaky_model = em_mod.expectation_maximisation(
        sequences, cigars, str(tmp_path / "flaky.txt"), options)

    assert calls["n"] >= 2
    np.testing.assert_array_equal(flaky_model.transitions, clean.transitions)
    np.testing.assert_array_equal(flaky_model.emissions, clean.emissions)
    assert flaky_model.likelihood == clean.likelihood


def test_em_retry_exhaustion_raises(tmp_path, monkeypatch):
    """When every retry fails the run fails loudly (no silent count loss)."""
    sequences, cigars = make_corpus(2, 30, seed=4)
    options = EmOptions(modelType="fiveState", iterations=1, trials=1,
                        retryCount=1, seed=5)

    def always_fail(*args, **kwargs):
        raise RuntimeError("persistent failure")

    monkeypatch.setattr(em_mod, "expectation_step", always_fail)
    monkeypatch.setattr("cpecan_tpu.utils.retry.time",
                        type("T", (), {"sleep": staticmethod(lambda s: None)}))
    with pytest.raises(RuntimeError, match="persistent failure"):
        em_mod.expectation_maximisation(
            sequences, cigars, str(tmp_path / "m.txt"), options)
