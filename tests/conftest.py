"""Test config: run JAX on a virtual 8-device CPU mesh.

Sharding/collective code paths are identical on the virtual CPU mesh and
real devices; chip_smoke.py exercises the GPU.

The platform is also forced through jax.config, in case jax was imported
before this file ran.
"""

import functools
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# CPU unless the caller names platforms (the `gpu`-marked tests are run
# with JAX_PLATFORMS=cuda,cpu on a machine with a card)
os.environ["JAX_PLATFORMS"] = os.environ.get("JAX_PLATFORMS") or "cpu"

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

from cpecan_tpu.utils.jaxcache import enable_compilation_cache

enable_compilation_cache()

import pytest


@pytest.fixture
def interpreted_kernels(monkeypatch):
    """Let fb_batch's dispatch choose the GPU kernels on this CPU backend
    and run them in the Pallas interpreter (interpret=True)."""
    from cpecan_tpu.ops import fb_batch, fb_wavefront

    monkeypatch.setattr(fb_batch, "_on_gpu", lambda: True)
    monkeypatch.setattr(
        fb_wavefront, "fb_pass_batch_wavefront",
        functools.partial(fb_wavefront.fb_pass_batch_wavefront,
                          interpret=True))


@pytest.fixture
def gpu():
    """A GPU device for tests marked `gpu`; skips where there is none.
    Decided here, when the test runs, never at import."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU device")
