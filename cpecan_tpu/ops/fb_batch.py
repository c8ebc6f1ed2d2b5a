"""Batched / sharded forward-backward execution with engine dispatch.

Two engines serve `fb_pass_batch`:

 * the lax.scan engine (ops/fb.py) vmapped over the batch — runs on any
   backend, supports every mode, and doubles as the numerical oracle;
 * the fused Pallas kernels (ops/fb_wavefront.py) — the GPU path for
   forward/posterior/expectation modes at band widths up to
   fb_wavefront.MAX_WIDTH.

Selection: env CPECAN_TPU_ENGINE in {"auto" (default), "scan",
"wavefront"}. "auto" picks the kernels on a GPU backend and the scan
engine otherwise; "wavefront" off a GPU is an error (the kernels compile
only for the GPU). Passing `nz` (the static nonzero-transition triples
from fb_wavefront.nonzero_transitions) makes the kernels usable inside
an outer trace (e.g. a jitted train step), where the transition values
are tracers.

Data parallelism: pass `mesh` (a 1-D Mesh over a "data" axis) and the
batch executes under jax.shard_map — each device runs the selected
engine on its batch shard, and in expectation mode the per-shard
(S, S) / (S, 4, 4) expected-count tensors are psum-reduced over the
mesh axis: the replacement for the reference's file-gather reduction
(cPecanEm.py:184-188). The kernels are per-device programs; shard_map
gives each device its shard without any cross-device layout inside the
kernel.

The chosen engine for the most recent call is recorded in LAST_ENGINE
(one of "scan", "wavefront", "scan_sharded", "wavefront_sharded") so
tests and benchmarks can assert on the dispatch.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

from cpecan_tpu.ops import fb

# Most recent engine choice, for tests/telemetry.
LAST_ENGINE: str | None = None


@functools.partial(jax.jit, static_argnames=("mode", "width"))
def fb_pass_batch_scan(params, sx, sy, offsets, widths, lx, ly,
                       ragged_left, ragged_right, mode: str = "expectation",
                       width: int = 0):
    """Batch-of-pairs FB on the scan engine. All array args carry a leading
    batch axis; params are broadcast. In expectation mode the returned
    trans/emis are summed over the batch."""
    out = jax.vmap(
        lambda a, b, c, d, e, f, g, h: fb.fb_pass(
            params, a, b, c, d, e, f, g, h, mode=mode, width=width)
    )(sx, sy, offsets, widths, lx, ly, ragged_left, ragged_right)
    if mode == "expectation":
        out["trans"] = jnp.sum(out["trans"], axis=0)
        out["emis"] = jnp.sum(out["emis"], axis=0)
    return out


def _on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def _select_engine(params, sx, mode: str, mesh, nz, engine=None,
                   width: int = 0) -> str:
    from cpecan_tpu.ops import fb_wavefront

    if engine is None:
        engine = os.environ.get("CPECAN_TPU_ENGINE", "auto")
    if engine not in ("auto", "scan", "wavefront"):
        raise ValueError(f"unknown engine {engine!r}")
    on_gpu = _on_gpu()
    if engine == "wavefront" and not on_gpu:
        raise ValueError("the wavefront kernels compile only for a GPU "
                         f"(backend is {jax.default_backend()!r})")
    sharded = mesh is not None and mesh.devices.size > 1
    use_kernel = (engine != "scan" and on_gpu
                  and fb_wavefront.supported(mode)
                  and int(width) <= fb_wavefront.MAX_WIDTH)
    if use_kernel and nz is None and isinstance(params["t"], jax.core.Tracer):
        use_kernel = False  # can't derive the static transition structure
    if use_kernel and not sharded:
        sharding = getattr(sx, "sharding", None)
        if sharding is not None and len(sharding.device_set) > 1:
            # multi-device placement without an explicit mesh: the caller
            # wants jit auto-sharding, which only the scan engine supports
            use_kernel = False
    base = "wavefront" if use_kernel else "scan"
    return base + ("_sharded" if sharded else "")


# jitted shard_map callables by (engine, engine function, mesh, mode,
# width, nz): a fresh shard_map closure per call would re-trace and
# recompile every batch
_SHARDED: dict = {}


def _sharded_call(engine_fn, key, mesh, mode, params, *batch_args):
    """Run engine_fn per device shard under shard_map; psum the
    expectation counts over the data axis."""
    fn = _SHARDED.get(key)
    if fn is None:
        from jax.sharding import PartitionSpec as P

        data, rep = P("data"), P()
        in_specs = (jax.tree.map(lambda _: rep, params),) + (data,) * 8

        def per_shard(params, sx, sy, offsets, widths, lx, ly, rl, rr):
            out = engine_fn(params, sx, sy, offsets, widths, lx, ly, rl, rr)
            if mode == "expectation":
                out["trans"] = jax.lax.psum(out["trans"], "data")
                out["emis"] = jax.lax.psum(out["emis"], "data")
            return out

        # out_specs from the engine's actual output tree (the engines
        # differ in which per-pair diagnostics they emit per mode):
        # batch-sharded everywhere except the psum-replicated counts
        out_shapes = jax.eval_shape(engine_fn, params, *batch_args)
        out_specs = {k: rep if k in ("trans", "emis") else data
                     for k in out_shapes}
        # check_vma=False: pallas_call out_shapes don't carry vma
        # annotations; replication of trans/emis is established by the
        # explicit psums above
        fn = jax.jit(jax.shard_map(per_shard, mesh=mesh, in_specs=in_specs,
                                   out_specs=out_specs, check_vma=False))
        _SHARDED[key] = fn
    return fn(params, *batch_args)


def fb_pass_batch(params, sx, sy, offsets, widths, lx, ly,
                  ragged_left, ragged_right, mode: str = "expectation",
                  width: int = 0, mesh=None, nz=None, engine=None):
    """Batch-of-pairs FB with automatic engine selection (see module doc).

    mesh: optional 1-D Mesh over a "data" axis; the batch axis must be
      divisible by the mesh size. Runs the engine per shard under
      shard_map, with expectation counts psum-reduced across devices.
    nz: optional static nonzero-transition triples (from
      fb_wavefront.nonzero_transitions) enabling the kernels when params
      are tracers.
    engine: optional override of the CPECAN_TPU_ENGINE env selection
      ("auto" | "scan" | "wavefront").
    """
    global LAST_ENGINE
    engine = _select_engine(params, sx, mode, mesh, nz, engine, width)
    LAST_ENGINE = engine
    batch_args = (sx, sy, offsets, widths, lx, ly,
                  ragged_left, ragged_right)

    if engine.startswith("wavefront"):
        from cpecan_tpu.ops import fb_wavefront

        if nz is None:
            # must happen outside shard_map/jit: params are tracers inside
            nz = fb_wavefront.nonzero_transitions_of(params["t"])
        wf = functools.partial(fb_wavefront.fb_pass_batch_wavefront,
                               mode=mode, width=width, nz=nz)
        if engine == "wavefront_sharded":
            key = (engine, fb_wavefront.fb_pass_batch_wavefront, mesh, mode,
                   width, nz)
            return _sharded_call(wf, key, mesh, mode, params, *batch_args)
        return wf(params, *batch_args)

    scan = functools.partial(fb_pass_batch_scan, mode=mode, width=width)
    if engine == "scan_sharded":
        # under shard_map the batch-sum in fb_pass_batch_scan is per-shard;
        # the psum in _sharded_call completes the reduction
        return _sharded_call(scan, (engine, mesh, mode, width), mesh, mode,
                             params, *batch_args)
    return scan(params, *batch_args)


def shard_batch(arrays: dict, mesh=None, axis: str = "data") -> dict:
    """Place batch-leading arrays with a NamedSharding over `axis` so the
    batched FB executes data-parallel across the mesh."""
    if mesh is None:
        return arrays
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))
    return {k: jax.device_put(v, sharding) for k, v in arrays.items()}
