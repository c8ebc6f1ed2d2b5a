"""Device-mesh helpers.

The framework scales data-parallel over a 1-D `data` mesh axis: read-pair
batches sharded across devices, the HMM replicated, expectation count
tensors reduced with XLA collectives (NCCL all-reduce between GPUs; the
cards of one host are joined all to all, so a 1-D mesh needs no
topology mapping). Multi-host launch uses jax.distributed; the same code
path runs on a virtual CPU mesh (xla_force_host_platform_device_count)
for testing — no mocks.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def data_mesh(n_devices: int | None = None) -> Mesh:
    """1-D data-parallel mesh over the first n_devices devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("data",))


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None) -> None:
    """Multi-host init (no-op for single-process runs). The reference's
    jobTree cluster scatter (cPecanEm.py:423) maps to multi-controller JAX:
    every host runs the same program on its shard of the corpus.

    On the CPU backend (tests, dev boxes) cross-process collectives need
    the gloo transport; on GPUs XLA uses NCCL."""
    if num_processes is not None and num_processes > 1:
        platforms = jax.config.jax_platforms or ""
        if "cpu" in platforms:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)


def process_shard(items: list) -> list:
    """This process's shard of a globally-identical work list — the
    host-level scatter replacing jobTree's per-chunk jobs
    (cPecanEm.py:166-171). All processes must pass the same list."""
    return list(items)[jax.process_index()::jax.process_count()]


def all_sum_across_processes(arrays: list) -> list:
    """Element-wise sum of per-process numpy arrays across all processes —
    the expectation-count reduction (the pipeline's only collective;
    reference file-gather sum, cPecanEm.py:184-188). Single-process: the
    identity."""
    if jax.process_count() == 1:
        return [np.asarray(a, np.float64) for a in arrays]
    from jax.experimental import multihost_utils

    flat = np.concatenate(
        [np.asarray(a, np.float64).ravel() for a in arrays])
    gathered = np.asarray(
        multihost_utils.process_allgather(flat))  # (n_proc, n)
    total = gathered.sum(axis=0)
    out = []
    pos = 0
    for a in arrays:
        a = np.asarray(a)
        n = a.size
        out.append(total[pos : pos + n].reshape(a.shape))
        pos += n
    return out


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
