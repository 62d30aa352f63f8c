"""Coverage for profiling + adaptive adjuster utilities."""

import time

import pytest

from flow_guided_krylov_tpu.utils import AdaptiveAdjuster, StageTimer


def test_stage_timer():
    t = StageTimer()
    with t.span("a"):
        time.sleep(0.01)
    with t.span("a"):
        pass
    s = t.summary()
    assert s["a"]["calls"] == 2
    assert s["a"]["total_s"] >= 0.01
    assert "a" in t.dump()


def test_adaptive_adjuster():
    adj = AdaptiveAdjuster(patience=5)
    hist = {"unique_ratios": [0.95] * 10,
            "energies": [-1.0] * 5 + [-1.2] * 5}
    tips = adj.suggest(hist)
    assert "samples_per_batch" in tips
    hist2 = {"unique_ratios": [0.5] * 10, "energies": [-1.0] * 20}
    assert "max_epochs" not in adj.suggest(hist2)


def test_memory_budget_knobs():
    """HBM-aware sizing (reference system_scaler.py:399-437 analog):
    knobs scale with the memory size and respect their clamps."""
    from flow_guided_krylov_tpu.utils import MemoryBudget, device_memory_bytes

    assert device_memory_bytes() > 1 << 28      # something sensible reported

    small = MemoryBudget(4 << 30)
    big = MemoryBudget(64 << 30)
    assert small.connection_table_entries() < big.connection_table_entries()
    assert small.nqs_chunk_size(20) <= big.nqs_chunk_size(20)
    assert small.nqs_chunk_size(20) % 1024 == 0
    assert 4096 <= small.nqs_chunk_size(20, [512] * 6) <= 131072
    assert small.dense_hamiltonian_cap() < big.dense_hamiltonian_cap()
    assert 16 <= small.statevector_sites_cap() <= 28
    assert small.statevector_sites_cap() < big.statevector_sites_cap()

    # wider networks need shorter chunks at the same budget
    assert small.nqs_chunk_size(20, [1024] * 8) <= \
        small.nqs_chunk_size(20, [64])


def test_system_scaler_memory_parameters():
    from flow_guided_krylov_tpu.utils import SystemScaler
    p = SystemScaler(10_000).memory_parameters(n_sites=20,
                                               hidden_dims=[256] * 4)
    assert set(p) == {"nqs_chunk_size", "connection_table_max_entries",
                      "dense_local_energy_max_dim", "statevector_sites_cap"}
    assert all(v > 0 for v in p.values())


class _FakeDevice:
    """Stands in for a jax Device: platform, kind and memory_stats()."""

    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_device_memory_bytes_raises_without_bytes_limit(stats):
    """An accelerator that reports no bytes_limit is an error, not a
    guessed size."""
    from flow_guided_krylov_tpu.utils.memory import device_memory_bytes
    with pytest.raises(RuntimeError, match="bytes_limit"):
        device_memory_bytes(_FakeDevice("gpu", stats))


def test_device_memory_bytes_reads_bytes_limit():
    from flow_guided_krylov_tpu.utils.memory import device_memory_bytes
    dev = _FakeDevice("gpu", {"bytes_limit": 60 << 30})
    assert device_memory_bytes(dev) == 60 << 30


def test_lanczos_ell_m_is_budget_bound_not_clamped():
    """The Krylov depth follows the memory budget alone: a large card
    reaches m_max at 2^24 states, a small one is cut to its budget."""
    from flow_guided_krylov_tpu.utils import MemoryBudget
    n, c = 1 << 24, 24
    assert MemoryBudget(60 << 30).lanczos_ell_m(n, c, m_max=120) == 120
    small = MemoryBudget(16 << 30).lanczos_ell_m(n, c, m_max=120)
    block = 0.40 * (16 << 30) - 2 * c * n * 4 - 8 * n * 4
    assert small == int(block / (n * 4)) - 1


def test_compilation_cache_honours_env(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the program sets no path."""
    import jax
    from flow_guided_krylov_tpu.utils import profiling
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    profiling.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_compilation_cache_defaults_inside_checkout(monkeypatch):
    import os

    import jax
    from flow_guided_krylov_tpu.utils import profiling
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        profiling.enable_compilation_cache()
        path = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert path == profiling.CACHE_DIR


def test_peaks_table_refuses_unknown_devices():
    from flow_guided_krylov_tpu.utils.device_peaks import peaks_for
    assert peaks_for("NVIDIA H100 80GB HBM3").hbm_bytes_s == 3.35e12
    for kind in ("cpu", "NVIDIA L4", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(KeyError):
            peaks_for(kind)


_SRC = "extern \"C\" int fgk_probe(void) { return %d; }\n"


def test_native_build_rebuilds_stale_library(tmp_path, monkeypatch):
    """A library older than its source is rebuilt; the build goes through
    a temporary file renamed into place, so none is left behind."""
    import os
    import shutil

    from flow_guided_krylov_tpu.utils import native_build as nb
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    (tmp_path / "native").mkdir()
    src = tmp_path / "native" / "probe.cpp"
    build = tmp_path / "build" / "native"
    monkeypatch.setattr(nb, "REPO_ROOT", str(tmp_path))
    monkeypatch.setattr(nb, "BUILD_DIR", str(build))

    src.write_text(_SRC % 1)
    assert nb.load_native("probe.cpp", "libprobe1.so").fgk_probe() == 1
    # stale: the built library (moved to a fresh name, since this process
    # keeps the first one loaded) is older than the edited source
    stale = build / "libprobe2.so"
    os.replace(build / "libprobe1.so", stale)
    src.write_text(_SRC % 2)
    t = os.path.getmtime(src)
    os.utime(stale, (t - 10, t - 10))
    assert nb.load_native("probe.cpp", "libprobe2.so").fgk_probe() == 2
    assert sorted(p.name for p in build.iterdir()) == ["libprobe2.so"]


def test_native_build_missing_source_returns_none(tmp_path, monkeypatch):
    from flow_guided_krylov_tpu.utils import native_build as nb
    monkeypatch.setattr(nb, "REPO_ROOT", str(tmp_path))
    monkeypatch.setattr(nb, "BUILD_DIR", str(tmp_path / "build"))
    assert nb.load_native("absent.cpp", "libabsent.so") is None
