"""How `SortformerDiarizer.process_offline` gets a recording onto the device.

The samples are copied into a staging buffer the diarizer reuses (grown,
never shrunk; page-locked on a card), only this rank's real samples go up,
and the tail past them is zeroed on the device. The tensor `offline_windows`
receives must equal the zero-padded flat buffer of `(bucket + 1) * step`
samples that the diarizer used to build on the host, sliced to this rank's
windows, for every request of a sequence in which a long recording leaves
its samples in the buffer before shorter ones. The `diar.upload` span
counts the real bytes, `pinned` and `staging_grown`.

The card case is marked `cuda` and skips without one. The file imports no
JAX, so on a card machine it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sortformer_staging.py
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fluidaudio_tpu_torch.diarizer import sortformer as sf
from fluidaudio_tpu_torch.diarizer.sortformer import SortformerDiarizer
from fluidaudio_tpu_torch.models.sortformer import SORTFORMER_TEST
from fluidaudio_tpu_torch.utils import profiling

CKPT = Path(__file__).resolve().parents[1] / "fluidaudio_tpu" / "assets" / "trained_tiny" / "sortformer"
STEP = 3072 * 160 - 64 * 1280
# the longest first, so the buffer grows once and later requests read over its stale samples
LENGTHS = (120.0, 20.0, 70.0, 1.0)
BUCKETS = (8, 1, 4, 1)  # 5, 1, 3 and 1 windows, rounded up to a power of two


class FakeMesh:
    """Rank `rank` of a `n_data` x 1 mesh, as `axis_size` and `local_rows` read one."""

    mesh_dim_names = ("data", "model")

    def __init__(self, n_data: int, rank: int):
        self.shape, self.rank = (n_data, 1), rank

    def get_local_rank(self, axis: str) -> int:
        return self.rank


def recording(seconds: float, dtype, seed: int) -> np.ndarray:
    x = np.random.RandomState(seed).randn(int(seconds * 16000)) * 0.1
    return (x * 32767).astype(np.int16) if dtype == np.int16 else x.astype(np.float32)


def zero_padded(samples: np.ndarray, bucket: int, rows: slice) -> np.ndarray:
    """The host buffer `process_offline` used to build and upload."""
    flat = np.zeros((bucket + 1) * STEP, samples.dtype)
    flat[: min(samples.size, flat.size)] = samples[: flat.size]
    return flat[rows.start * STEP:(rows.stop + 1) * STEP]


def upload_counts() -> list[dict]:
    return [r.counts for r in profiling.spans() if r.name == "diar.upload"]


@pytest.mark.parametrize("dtype", [np.float32, np.int16], ids=["f32", "int16"])
@pytest.mark.parametrize("mesh", [None, (1, 0), (2, 0), (2, 1)],
                         ids=["no_mesh", "mesh1x1", "mesh2_rank0", "mesh2_rank1"])
def test_staged_upload_equals_the_zero_padded_buffer(monkeypatch, dtype, mesh):
    d = SortformerDiarizer(SORTFORMER_TEST, checkpoint_dir=CKPT, device="cpu")
    n_data, rank = mesh or (1, 0)
    if mesh:
        d.set_mesh(FakeMesh(n_data, rank))
        monkeypatch.setattr(sf, "gather_rows", lambda m, x: torch.cat([x] * n_data))
    seen = []

    def offline_windows(flat, n_windows, step, window_samples):
        seen.append((flat.clone(), n_windows))
        return torch.zeros(n_windows, 384, 4)

    monkeypatch.setattr(d, "offline_windows", offline_windows)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for i, seconds in enumerate(LENGTHS):
            d.process_offline(recording(seconds, dtype, i))
    counts = upload_counts()
    profiling.reset()
    assert len(seen) == len(counts) == len(LENGTHS)
    for i, (seconds, bucket) in enumerate(zip(LENGTHS, BUCKETS)):
        bucket = -(-bucket // n_data) * n_data
        per = bucket // n_data
        rows = slice(rank * per, (rank + 1) * per)
        samples = recording(seconds, dtype, i)
        want = zero_padded(samples, bucket, rows)
        flat, n_windows = seen[i]
        assert n_windows == per
        assert flat.dtype == torch.from_numpy(want).dtype
        assert torch.equal(flat, torch.from_numpy(want))
        real = samples[rows.start * STEP:(rows.stop + 1) * STEP]
        assert counts[i] == {"bytes": real.nbytes, "pinned": 0, "staging_grown": int(i == 0)}
    assert not d._staging.is_pinned()


@pytest.mark.cuda
def test_staged_upload_on_the_card():
    """On a card the buffer is page-locked, and a request after a longer one
    gives the predictions and segments of a fresh diarizer, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    cuda = torch.device("cuda", 0)

    def run(d: SortformerDiarizer, samples: np.ndarray):
        preds = []
        windows = d.offline_windows
        d.offline_windows = lambda *a: preds.append(windows(*a)) or preds[-1]
        try:
            segs = [vars(s) for s in d.process_offline(samples).segments]
        finally:
            del d.offline_windows
        return preds[0].cpu(), segs

    reused = SortformerDiarizer(SORTFORMER_TEST, checkpoint_dir=CKPT, device=cuda)
    long, short = recording(120.0, np.int16, 0), recording(70.0, np.int16, 1)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        run(reused, long)
        got = run(reused, short)
    counts = upload_counts()
    profiling.reset()
    assert reused._staging.is_pinned()
    assert [(c["pinned"], c["staging_grown"]) for c in counts] == [(1, 1), (1, 0)]
    want = run(SortformerDiarizer(SORTFORMER_TEST, checkpoint_dir=CKPT, device=cuda), short)
    assert torch.equal(got[0], want[0])
    assert got[1] == want[1]
