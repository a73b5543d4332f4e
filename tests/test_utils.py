"""Tests for profiling utils and multihost helpers (single-process)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from approximatenn.parallel import multihost
from approximatenn.parallel.sharded import make_mesh
from approximatenn.utils.profiling import StageTimes, trace


def test_stage_times_accumulate():
    st = StageTimes()
    with st.stage("a") as sink:
        sink.append(jnp.ones((4, 4)) * 2)
    with st.stage("a"):
        pass
    assert st.counts["a"] == 2 and st.totals["a"] > 0
    assert "a" in st.report()


def test_fence_handles_non_arrays():
    """A stage waits on whatever its body appends, arrays or not."""
    st = StageTimes()
    with st.stage("mixed") as sink:
        sink.append({"x": 1, "y": None})
        sink.append(jnp.arange(5))
    assert st.counts["mixed"] == 1


def test_on_accelerator():
    from approximatenn.utils.runtime import on_accelerator

    class Dev:
        def __init__(self, platform):
            self.platform = platform

    assert not on_accelerator(jax.devices())  # the CPU test mesh
    assert on_accelerator([Dev("gpu"), Dev("gpu")])
    assert not on_accelerator([Dev("gpu"), Dev("cpu")])


@pytest.mark.parametrize("env_dir", [None, "from_env"])
def test_enable_compile_cache(env_dir, monkeypatch, tmp_path):
    """$JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed
    directory inside the checkout.  Every compile is cached."""
    from approximatenn.utils import runtime

    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(runtime.COMPILE_CACHE_DIR)
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    try:
        assert runtime.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    finally:
        jax.config.update("jax_compilation_cache_dir", old[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])
    repo = runtime.COMPILE_CACHE_DIR.parent
    assert (repo / "approximatenn").is_dir()
    assert ".jax_cache/" in (repo / ".gitignore").read_text().split()


@pytest.mark.parametrize("stats, want", [
    ({"bytes_limit": 1000}, 250),
    (None, 7),  # no memory_stats at all (the CPU backend)
    ({"bytes_in_use": 5}, 7),  # stats without a limit
])
def test_memory_budget(stats, want):
    from approximatenn.utils.runtime import memory_budget

    class Dev:
        def memory_stats(self):
            return stats

    assert memory_budget(0.25, 7, Dev()) == want


def test_alias_package():
    """A second name returns the very modules of the package, submodules
    included, with their own specs intact."""
    import importlib
    import sys

    import approximatenn
    import approximatenn.engine.serving as serving
    from approximatenn.utils.alias import alias_package

    finder = alias_package("ann_alias_probe", "approximatenn")
    try:
        assert importlib.import_module("ann_alias_probe") is approximatenn
        mod = importlib.import_module("ann_alias_probe.engine.serving")
        assert mod is serving
        assert mod.__spec__.name == "approximatenn.engine.serving"
        from ann_alias_probe.engine.serving import Server  # noqa: F401

        assert Server is approximatenn.Server
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module("ann_alias_probe.no_such_module")
    finally:
        sys.meta_path.remove(finder)
        for name in [m for m in sys.modules if m.startswith("ann_alias_probe")]:
            del sys.modules[name]


@pytest.mark.slow
def test_trace_noops_gracefully(tmp_path):
    with trace(str(tmp_path)) as d:
        jnp.ones(3).sum()
    assert d == str(tmp_path)


def test_global_mesh_and_slices():
    multihost.initialize()  # no-op single process
    mesh = multihost.global_mesh()
    n_dev = len(jax.devices())
    lo, hi = multihost.host_shard_slice(8 * n_dev, mesh)
    assert (lo, hi) == (0, 8 * n_dev)  # single host owns everything


def test_process_local_array_roundtrip(rng):
    mesh = make_mesh()
    n_dev = len(list(mesh.devices.flat))
    data = rng.standard_normal((4 * n_dev, 3)).astype(np.float32)
    arr = multihost.process_local_array(data.shape, mesh, data)
    np.testing.assert_array_equal(np.asarray(arr), data)


def test_device_init_and_cleanup_registry():
    from approximatenn.utils import runtime

    dev = runtime.device_init()
    assert dev is not None
    order = []
    runtime.register_cleanup(lambda: order.append("a"))
    runtime.register_cleanup(lambda: order.append("b"))
    runtime.register_cleanup(lambda: 1 / 0)  # exceptions suppressed
    runtime.cleanup()
    assert order == ["b", "a"]  # LIFO
    info = runtime.device_summary()
    assert info["device_count"] >= 1


def test_device_init_float64_requires_x64():
    import pytest
    from approximatenn.utils import runtime

    with pytest.raises(RuntimeError, match="x64"):
        runtime.device_init(require_dtype="float64")
