"""The readers of the program's own spans (`fluidaudio_tpu_torch.utils.
profiling`): nothing to read after `reset()` or in a program without
spans, and the expected values on spans recorded under a CPU profiler
(CUDA events faked: each span on the card reads 2 ms)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import run
from fluidaudio_tpu_torch.utils import profiling

READERS = ("host_work_ms_per_min.diar", "upload_ms_per_min.diar", "window_fill.diar",
           "mel_dev_ms_per_min.diar", "encoder_dev_ms_per_min.diar", "head_dev_ms_per_min.diar")


def reader(name):
    return run.load_module(run.BENCH / "metrics" / f"{name}.py", "metric_" + name)


class FakeEvent:
    """Each record takes the next tick; a tick is 2 ms."""

    ticks = 0

    def __init__(self, enable_timing=False):
        self.tick = None

    def record(self, stream=None):
        FakeEvent.ticks += 1
        self.tick = FakeEvent.ticks

    def elapsed_time(self, end):
        return 2.0 * (end.tick - self.tick)


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    profiling.reset()
    yield
    profiling.reset()


def request(audio_s, windows, rows):
    """One offline request's spans, as `process_offline` nests them."""
    with profiling.span("diar.request", audio_s=audio_s) as req:
        with profiling.span("diar.plan"):
            pass
        req.set(windows=windows, bucket_rows=rows)
        for name in ("diar.upload", "mel", "encoder", "sortformer.head"):
            with profiling.span(name, device="cuda"):
                pass
        for name in ("diar.download", "diar.stitch", "diar.segments"):
            with profiling.span(name):
                pass


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_after_reset(fake_cuda, name):
    with profile(activities=[ProfilerActivity.CPU]):
        request(60.0, 2, 2)
    profiling.reset()
    assert reader(name).read(run.Run()) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_in_a_program_without_spans(fake_cuda, monkeypatch, name):
    with profile(activities=[ProfilerActivity.CPU]):
        request(60.0, 2, 2)
    monkeypatch.delattr(profiling, "summary")
    assert reader(name).read(run.Run()) is None


def test_readers_on_recorded_spans(fake_cuda):
    """Two requests, 3 of 4 and 5 of 8 rows real, 2 min of audio in all."""
    with profile(activities=[ProfilerActivity.CPU]):
        request(50.0, 3, 4)
        request(70.0, 5, 8)
    host = sum(r.host_s for r in profiling.spans()
               if r.name in ("diar.plan", "diar.stitch", "diar.segments"))
    r = run.Run()
    assert reader("window_fill.diar").read(r) == pytest.approx(100 * 8 / 12)
    assert reader("host_work_ms_per_min.diar").read(r) == pytest.approx(host * 1e3 / 2)
    for name in ("upload", "mel_dev", "encoder_dev", "head_dev"):
        # two spans of 2 ms over 2 minutes
        assert reader(f"{name}_ms_per_min.diar").read(r) == pytest.approx(2.0), name
