"""The port's spans (`utils/profiling.py::span`) on the CPU.

- With no profiler recording, a span makes no record and no CUDA event.
- Under `torch.profiler.profile`, spans nest, share the outermost span's
  request id, carry their counts, and are stamped on kineto's clock: a
  span brackets the `aten::mm` run inside it.
- On a CUDA device a span records two timing events on the device's
  current stream and syncs nothing; `summary()` reads them after one
  synchronize (CUDA faked here).
- `trace()` merges the spans into its Chrome trace, and `trace(None)`
  writes a new directory on each call.
- `SortformerDiarizer.process_offline` at SORTFORMER_TEST: the nine spans
  once per request, with its own plan's window and bucket counts, and the
  request's host time split exactly into self times.
"""

from __future__ import annotations

import json
import tempfile
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fluidaudio_tpu_torch.diarizer.sortformer import SortformerDiarizer
from fluidaudio_tpu_torch.models.sortformer import SORTFORMER_TEST
from fluidaudio_tpu_torch.utils import profiling
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

OFFLINE_SPANS = ("diar.request", "diar.plan", "diar.upload", "mel", "encoder",
                 "sortformer.head", "diar.download", "diar.stitch", "diar.segments")


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class FakeEvent:
    """`torch.cuda.Event` on a CPU build: each record takes the next tick;
    a tick is 2 ms of device time."""

    made = 0
    ticks = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.tick = None
        self.stream = None

    def record(self, stream=None):
        FakeEvent.ticks += 1
        self.tick, self.stream = FakeEvent.ticks, stream

    def elapsed_time(self, end):
        return 2.0 * (end.tick - self.tick)


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA events, streams and synchronize faked; -> the list of syncs."""
    syncs = []
    FakeEvent.made = FakeEvent.ticks = 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: ("stream", device))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: syncs.append(device))
    profiling.reset()
    yield syncs
    profiling.reset()


@pytest.fixture(scope="module")
def diarizer():
    return SortformerDiarizer(SORTFORMER_TEST, device="cpu")


def audio(seconds: float, seed: int = 0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(int(seconds * 16000)) * 0.1).astype(np.float32)


def test_no_profiler_no_record_and_no_event(fake_cuda, diarizer):
    with profiling.span("a", device="cuda:0", x=1) as h:
        h.set(y=2)
        with profiling.span("b", device="cuda:0"):
            pass
    diarizer.process_offline(audio(40))
    assert profiling.spans() == [] and profiling.summary() == {}
    assert FakeEvent.made == 0 and fake_cuda == []


def test_spans_nest_share_the_request_and_carry_counts():
    profiling.reset()
    with cpu_profile():
        with profiling.span("req", n=3) as req:
            req.set(rows=4)
            with profiling.span("child") as child:
                with profiling.span("grandchild", k=1):
                    pass
                child.set(k=2)
        with profiling.span("req", n=5):
            pass
    recs = {(r.name, r.request): r for r in profiling.spans()}
    assert len(recs) == 4
    first = recs[("req", req.id)]
    assert first.parent is None and first.counts == {"n": 3, "rows": 4}
    assert recs[("child", req.id)].parent == req.id
    assert recs[("child", req.id)].counts == {"k": 2}
    assert recs[("grandchild", req.id)].parent == child.id
    second = [r for r in profiling.spans() if r.name == "req" and r.id != req.id][0]
    assert second.request == second.id != req.id
    s = profiling.summary()
    assert s["req"]["count"] == 2 and s["req"]["counts"] == {"n": 8, "rows": 4}
    assert s["child"]["counts"] == {"k": 2} and s["grandchild"]["counts"] == {"k": 1}
    assert s["req"]["device_s"] is None
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_stamps_bracket_kinetos_mm():
    """The span's Unix-ns stamps hold the kineto start of the `aten::mm`
    run inside it (1 ms of sleep on either side of the product)."""
    a = torch.ones(64, 64)
    a @ a
    profiling.reset()
    with cpu_profile() as prof:
        with profiling.span("mm") as sp:
            time.sleep(1e-3)
            a @ a
            time.sleep(1e-3)
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert sp.start_ns <= mm[0].start_ns() <= mm[0].start_ns() + mm[0].duration_ns() <= sp.end_ns
    assert sp.end_ns - sp.start_ns < 1e9
    profiling.reset()


def test_cuda_span_records_events_on_the_stream_without_a_sync(fake_cuda):
    with cpu_profile():
        with profiling.span("outer", device="cuda:0"):
            with profiling.span("host_only"):
                pass
            assert fake_cuda == []
    assert fake_cuda == []
    (host_only, outer) = profiling.spans()
    assert host_only.events is None
    start, end = outer.events
    assert start.stream == end.stream == ("stream", torch.device("cuda", 0))
    s = profiling.summary()
    assert fake_cuda == [torch.device("cuda", 0)]
    assert s["outer"]["device_s"] == pytest.approx(2e-3) and s["host_only"]["device_s"] is None


def test_cap_drops_the_oldest():
    tracer = profiling.Tracer(cap=3)
    with cpu_profile():
        for i in range(5):
            with tracer.span("s", i=i):
                pass
    assert [r.counts["i"] for r in tracer.spans()] == [2, 3, 4] and tracer.dropped() == 2
    assert tracer.summary()["s"]["count"] == 3


def test_trace_writes_every_span(tmp_path):
    a = torch.ones(64, 64)
    with profiling.trace(tmp_path / "t"):
        with profiling.span("outer", rows=2):
            time.sleep(1e-3)
            a @ a
            time.sleep(1e-3)
            with profiling.span("inner"):
                pass
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    ours = {e["name"]: e for e in events if e.get("cat") == "fluidaudio_span"}
    assert set(ours) == {"outer", "inner"}
    outer, inner = ours["outer"], ours["inner"]
    assert outer["args"]["rows"] == 2 and inner["args"]["parent"] == outer["args"]["id"]
    assert inner["args"]["request"] == outer["args"]["id"] and outer["ph"] == inner["ph"] == "X"
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert outer["ts"] <= mm["ts"] <= mm["ts"] + mm["dur"] <= outer["ts"] + outer["dur"]
    assert (outer["pid"], outer["tid"]) == (mm["pid"], mm["tid"])


def test_trace_none_writes_a_new_directory_each_call(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for _ in range(2):
        with profiling.trace(None):
            with profiling.span("x"):
                pass
    dirs = sorted(tmp_path.glob("fluidaudio_trace_*"))
    assert len(dirs) == 2 and all((d / "trace.json").exists() for d in dirs)


def test_process_offline_spans(diarizer, monkeypatch):
    """Nine spans once per request, its own plan's counts, and the request's
    host time split exactly into the self times of its spans."""
    plan = []
    model_forward, stitch = diarizer.model.forward, diarizer._stitch
    monkeypatch.setattr(diarizer.model, "forward",
                        lambda mel: plan.append(["rows", mel.shape[0]]) or model_forward(mel))
    monkeypatch.setattr(diarizer, "_stitch",
                        lambda windows: plan[-1].append(len(windows)) or stitch(windows))
    lengths = (70.0, 20.0, 120.0)
    profiling.reset()
    with cpu_profile():
        for i, s in enumerate(lengths):
            diarizer.process_offline(audio(s, i))
    recs = profiling.spans()
    requests = [r for r in recs if r.name == "diar.request"]
    assert len(requests) == 3 and len(recs) == 9 * 3
    for req, seconds, (_, rows, windows) in zip(requests, lengths, plan):
        mine = [r for r in recs if r.request == req.id]
        assert sorted(r.name for r in mine) == sorted(OFFLINE_SPANS)
        assert all(r.parent == req.id for r in mine if r is not req)
        assert req.counts == {"audio_s": seconds, "windows": windows, "bucket_rows": rows}
        upload = [r for r in mine if r.name == "diar.upload"][0]
        assert upload.counts == {"bytes": (rows + 1) * (3072 * 160 - 64 * 1280) * 4}
        children = [r for r in mine if r is not req]
        assert sum(r.end_ns - r.start_ns for r in children) <= req.end_ns - req.start_ns
        assert all(req.start_ns <= r.start_ns <= r.end_ns <= req.end_ns for r in children)
    assert [p[1:] for p in plan] == [[4, 3], [1, 1], [8, 5]]
    s = profiling.summary()
    assert {k: v["count"] for k, v in s.items()} == {k: 3 for k in OFFLINE_SPANS}
    assert sum(v["self_s"] for v in s.values()) == pytest.approx(s["diar.request"]["host_s"],
                                                                 rel=1e-9)
    assert s["diar.request"]["counts"] == {"audio_s": sum(lengths), "windows": 9,
                                           "bucket_rows": 13}
    profiling.reset()
