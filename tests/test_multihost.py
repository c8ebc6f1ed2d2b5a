"""Multi-host EM: 2 jax.distributed processes on the CPU backend must
reproduce the single-process model — same collectives code path as a
multi-host accelerator cluster (the reference ran its EM scatter on clusters via
jobTree, cPecanEm.py:423)."""

import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest

from cpecan_tpu.io import cigar as cigar_io
from cpecan_tpu.models.hmm import Hmm
from cpecan_tpu.utils.symbols import evolve_sequence, get_random_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = """
import os, sys
os.environ.pop("XLA_FLAGS", None)
import jax
jax.config.update("jax_platforms", "cpu")
# under pytest-xdist CPU contention the cross-process topology exchange
# can exceed its default deadline; give it slack (option names vary by
# jax version, hence the guards)
for opt, val in (("jax_cpu_get_local_topology_timeout_minutes", 10),
                 ("jax_cpu_get_global_topology_timeout_minutes", 10)):
    try:
        jax.config.update(opt, val)
    except Exception:
        pass
sys.path.insert(0, {repo!r})
from cpecan_tpu.utils.jaxcache import enable_compilation_cache
enable_compilation_cache()
from cpecan_tpu.cli import em as em_cli
sys.exit(em_cli.main({argv!r}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _make_corpus(tmp_path, n_pairs=6, n=40, seed=2):
    rng = random.Random(seed)
    sequences = {}
    lines = []
    for i in range(n_pairs):
        x = get_random_sequence(n, rng)
        y = evolve_sequence(x, rng) or "ACGTACGT"
        sequences[f"sx{i}"] = x
        sequences[f"sy{i}"] = y
        m = min(len(x), len(y))
        pa = cigar_io.PairwiseAlignment(
            f"sx{i}", 0, m, True, f"sy{i}", 0, m, True, 0.0,
            [(cigar_io.MATCH, m)])
        lines.append(cigar_io.cigar_format(pa))
    fasta = tmp_path / "seqs.fa"
    with open(fasta, "w") as fh:
        for name, seq in sequences.items():
            fh.write(f">{name}\n{seq}\n")
    cig = tmp_path / "in.cigar"
    with open(cig, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(fasta), str(cig)


def _em_argv(fasta, cig, out_model, extra=()):
    return ["--sequences", fasta, "--alignments", cig,
            "--outputModel", out_model, "--iterations", "2",
            "--trials", "1", "--trainEmissions",
            # tiny per-job cap so every cigar is its own chunk -> the
            # 2-process run actually shards work
            "--maxAlignmentLengthPerJob", "10",
            "--diagonalExpansion", "4",
            "--splitMatrixBiggerThanThis", "100",
            "--seed", "7", *extra]


@pytest.mark.slow
def test_two_process_em_matches_single(tmp_path):
    fasta, cig = _make_corpus(tmp_path)

    # single-process reference, in a subprocess for an identical env
    ref_model = str(tmp_path / "ref.hmm")
    res = subprocess.run(
        [sys.executable, "-c",
         _WORKER.format(repo=REPO, argv=_em_argv(fasta, cig, ref_model))],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]

    # 2-process distributed run against the same corpus.  One retry:
    # under full-suite xdist load the coordination-service rendezvous can
    # blow its deadline (timing, not correctness — the round-4 flake);
    # a genuine numeric/parity failure still fails both attempts below.
    out_model = str(tmp_path / "dist.hmm")
    last_err = None
    for attempt in range(2):
        port = _free_port()
        procs = []
        for pid in range(2):
            argv = _em_argv(fasta, cig, out_model,
                            extra=["--coordinator", f"127.0.0.1:{port}",
                                   "--numProcesses", "2",
                                   "--processId", str(pid)])
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER.format(repo=REPO, argv=argv)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=REPO))
        rcs, errs = [], []
        for pr in procs:
            out, err = pr.communicate(timeout=600)
            rcs.append(pr.returncode)
            errs.append(err)
        if all(rc == 0 for rc in rcs):
            break
        last_err = "".join(e[-2000:] for e in errs)
        deadline = "DEADLINE_EXCEEDED" in last_err or "timed out" in last_err
        assert attempt == 0 and deadline, last_err
    else:
        raise AssertionError(last_err)

    ref = Hmm.load(ref_model)
    got = Hmm.load(out_model)
    np.testing.assert_allclose(got.transitions, ref.transitions,
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.emissions, ref.emissions,
                               rtol=1e-6, atol=1e-9)
    assert got.likelihood == pytest.approx(ref.likelihood, rel=1e-6)
