"""Host modules of the PyTorch port: the sysinfo shim over the C source
`native/sysinfo/sysinfo.c` (built by `native/cxx.py` with the host C
compiler), `utils/system_info.py` and `utils/profiling.py`, on the CPU.

`tests/test_native.py::test_sysinfo_rss` runs on the port's own build
(`jax_cases`, its JAX native-loader imports edited out so that no cmake
build starts), and the port's RSS readings are held against /proc and
`resource`, what the JAX module falls back to.
"""

import json
import mmap

import numpy as np
import pytest
import torch

from fluidaudio_tpu_torch.native import cxx
from fluidaudio_tpu_torch.native import sysinfo as port_sysinfo
from fluidaudio_tpu_torch.ops.build import BUILD_DIR
from fluidaudio_tpu_torch.utils import profiling
from fluidaudio_tpu_torch.utils.system_info import SystemInfo
from tests.test_torch_custom_vocab import jax_cases, one_torch_thread  # noqa: F401

NATIVE_EDITS = (
    ("from fluidaudio_tpu.native import load_native\n"
     "from fluidaudio_tpu.native.fastcluster import centroid_linkage, cut_tree, native_available\n",
     ""),
    ('needs_native = pytest.mark.skipif(not native_available(), reason="native lib not built")',
     'needs_native = pytest.mark.skipif(False, reason="the port builds its library at first use")'),
)


@pytest.mark.parametrize("case", jax_cases("test_native.py", ("native.sysinfo", "itn"),
                                           ("test_sysinfo_rss",), edits=NATIVE_EDITS))
def test_jax_sysinfo_case_on_the_port(case):
    case()


def test_sysinfo_is_built_from_the_c_source_with_the_c_compiler():
    lib, _ = port_sysinfo.build_library()
    assert lib == port_sysinfo.library_path() and lib.parent == BUILD_DIR
    assert lib.name.startswith("libsysinfo_") and lib.exists()
    assert port_sysinfo.SOURCE.suffix == ".c" and not port_sysinfo.SOURCE.with_suffix(".h").exists()
    assert port_sysinfo.build_library() == (lib, 0.0)  # built once


def test_library_key_changes_with_the_flags_and_keeps_cpp_keys(monkeypatch, tmp_path):
    """A C source is keyed by its bytes and C_FLAGS; a C++ source's key (and
    so the libraries built before) does not change."""
    from fluidaudio_tpu_torch.native import flac

    src = port_sysinfo.SOURCE
    key = cxx.library_path(src, "sysinfo", tmp_path).name
    monkeypatch.setattr(cxx, "C_FLAGS", cxx.C_FLAGS + ("-g",))
    assert cxx.library_path(src, "sysinfo", tmp_path).name != key
    assert flac.library_path().name == "libflac_e04df55967b0f997.so"


def test_failed_c_build_raises(tmp_path):
    bad = tmp_path / "bad.c"
    bad.write_text("this is not C\n")
    with pytest.raises(RuntimeError, match="bad build failed"):
        cxx.build_library(bad, "bad", tmp_path / "build", "bad")
    assert not list((tmp_path / "build").glob("*"))  # no partial library left


def test_rss_reads_proc_as_the_jax_fallback_does():
    """The shim reads /proc/self as the JAX module's fallbacks do: its peak is
    the kernel's VmHWM (/proc/self/status) and its current RSS
    /proc/self/statm, each read in this process around the shim's call; the
    current RSS grows by 64 MiB of fresh pages touched. `resource`'s
    ru_maxrss (the JAX peak fallback) is not held against it: Linux carries
    the high-water mark of the process that spawned this one across fork and
    exec (a pytest-xdist worker inherits its parent's), so it can exceed
    VmHWM by any amount, and it lags VmHWM by the kernel's unsynced RSS
    counters. The JAX functions themselves are not called here, since they
    start the JAX loader's cmake build."""
    def vm_hwm():
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmHWM:"))

    def statm():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * 4096

    before = vm_hwm()
    peak = port_sysinfo.peak_rss_bytes()
    assert before <= peak <= vm_hwm()
    now = statm()
    cur = port_sysinfo.current_rss_bytes()
    assert abs(cur - now) < 16 * 1024 * 1024 and abs(cur - statm()) < 16 * 1024 * 1024
    # 64 MiB of fresh anonymous pages, each touched: a malloc'd block can
    # come from heap pages a long-lived worker already holds resident
    block = mmap.mmap(-1, 64 * 1024 * 1024)
    pages = np.frombuffer(block, dtype=np.uint8)
    pages[::4096] = 1
    grown = port_sysinfo.current_rss_bytes()
    assert grown >= cur + 32 * 1024 * 1024
    assert port_sysinfo.peak_rss_bytes() >= max(peak, grown)
    assert vm_hwm() >= port_sysinfo.peak_rss_bytes() - 16 * 1024 * 1024
    del pages
    block.close()


def test_system_info_lists_cuda_devices_by_name(monkeypatch):
    assert SystemInfo.accelerators() == ([torch.cuda.get_device_name(i)
                                          for i in range(torch.cuda.device_count())]
                                         if torch.cuda.is_available() else [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card{i}")
    assert SystemInfo.accelerators() == ["card0", "card1"]


def test_system_info_does_not_hide_a_failing_cuda_query(monkeypatch):
    def broken(i):
        raise RuntimeError("CUDA error: unknown error")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", broken)
    with pytest.raises(RuntimeError, match="unknown error"):
        SystemInfo.accelerators()


def test_system_info_summary_and_memory():
    info = SystemInfo()
    assert info.peak_memory_mb() >= info.current_memory_mb() / 2 > 10
    assert f"{info.cpu_count} cpus" in info.summary() and "peak" in info.summary()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "t") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert trace["traceEvents"] and prof is not None
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_span_records_a_stage_under_the_profiler():
    """`span`, which took `signpost`'s place: a stage interval recorded while
    a profiler records, and nothing recorded outside one."""
    profiling.reset()
    with profiling.span("enc"):
        torch.ones(8).sum()
    assert profiling.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("enc"):
            torch.ones(8).sum()
    (rec,) = profiling.spans()
    assert rec.name == "enc" and rec.host_s > 0
    assert profiling.summary()["enc"]["host_s"] == rec.host_s
    profiling.reset()


def test_span_does_not_synchronise_the_card(monkeypatch):
    """Where `signpost` synchronised the card at each stage end, a span on a
    CUDA device records two events and syncs nothing."""
    calls, made = [], []

    class Event:
        def __init__(self, enable_timing=False):
            made.append(enable_timing)

        def record(self, stream=None):
            pass

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("dec", device="cuda"):
            pass
    assert calls == [] and made == [True, True]
    assert [r.name for r in profiling.spans()] == ["dec"]
    profiling.reset()


def test_device_memory_stats_per_device(monkeypatch):
    assert profiling.device_memory_stats() == ({} if not torch.cuda.is_available() else
                                               profiling.device_memory_stats())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {"allocated_bytes.all.peak": i})
    assert profiling.device_memory_stats() == {"cuda:0": {"allocated_bytes.all.peak": 0},
                                               "cuda:1": {"allocated_bytes.all.peak": 1}}
