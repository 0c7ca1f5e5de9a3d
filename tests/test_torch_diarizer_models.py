"""Diarization models and host stages of the PyTorch port against JAX.

The same seeded inputs (numpy) go through the JAX modules and the port's:

- segmentation logits of both archs (`PyannoteSegmentation` from the trained
  `offline/segmentation.npz` and at the default width with seeded weights;
  `PyanNet` at the upstream width), `powerset_to_binary`, `clean_frame_mask`:
  logits within REL_L2 relative L2, argmax classes equal;
- WeSpeaker embeddings (trained fixture and full ResNet34) within REL_L2,
  and the 80-mel fbank within MEL_ATOL;
- the offline segmentation processor's weights and binary, the embedding
  extractor, `interpolate_weights`, PLDA, VBx (labels equal, posteriors
  and pi within GAMMA_ATOL, ELBO trace within ELBO_RTOL, the speaker-count
  constraints' labels equal) and AHC (the native library's dendrogram and
  labels against JAX's, and against SciPy, its plain version; a failed
  build raises).

Tolerances: REL_L2 = 1e-5 (f32 reductions in another order; measured
~1e-6); MEL_ATOL = 1e-2 on log-mel (the two frontends' f32 DFTs differ by a
few 1e-3 on the quietest bins, `ROADMAP.md` "Not port faults"); GAMMA_ATOL =
1e-4 and ELBO_RTOL = 1e-5 (VBx runs in f32 on both sides, numpy here and
XLA there, whose exp/log differ by an ulp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.cluster.hierarchy import fcluster, linkage

from fluidaudio_tpu.diarizer.offline import ahc as jax_ahc
from fluidaudio_tpu.diarizer.offline import embedding as jax_emb
from fluidaudio_tpu.diarizer.offline import plda as jax_plda
from fluidaudio_tpu.diarizer.offline import segmentation as jax_seg
from fluidaudio_tpu.diarizer.offline import vbx as jax_vbx
from fluidaudio_tpu.diarizer.offline.types import EmbeddingOptions, SegmentationOptions, VBxOptions
from fluidaudio_tpu.models import pyannote_seg as jax_pyannote
from fluidaudio_tpu.models import wespeaker as jax_wespeaker
from fluidaudio_tpu.native import fastcluster as jax_fastcluster
from fluidaudio_tpu.train import fixtures as jax_fixtures
from fluidaudio_tpu.train import tiny_corpus as jax_tc
from fluidaudio_tpu.utils.checkpoint import load_params
from fluidaudio_tpu_torch.diarizer.offline import ahc as port_ahc
from fluidaudio_tpu_torch.diarizer.offline import embedding as port_emb
from fluidaudio_tpu_torch.diarizer.offline import plda as port_plda
from fluidaudio_tpu_torch.diarizer.offline import segmentation as port_seg
from fluidaudio_tpu_torch.diarizer.offline import vbx as port_vbx
from fluidaudio_tpu_torch.diarizer.offline import types as port_types
from fluidaudio_tpu_torch.models import pyannote_seg as port_pyannote
from fluidaudio_tpu_torch.models import wespeaker as port_wespeaker
from fluidaudio_tpu_torch.native import fastcluster as port_fastcluster
from fluidaudio_tpu_torch.train import fixtures as port_fixtures
from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_npz, load_state
from tests.test_torch_custom_vocab import jax_native_on_the_port_build, one_torch_thread  # noqa: F401

REL_L2 = 1e-5
MEL_ATOL = 1e-2
GAMMA_ATOL = 1e-4
ELBO_RTOL = 1e-5
OFFLINE = jax_fixtures.trained_assets_dir() / "offline"


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def waves(seed: int, n: int = 2) -> np.ndarray:
    """Speaker-like audio: the diarizer corpus's harmonic stacks over noise."""
    rs = np.random.RandomState(seed)
    out = (rs.randn(n, 160_000) * 0.01).astype(np.float32)
    for i in range(n):
        out[i, 20_000:100_000] += jax_tc.speaker_wave(i % 2, 5.0, rs)
    return out


def _to_port(module, jax_params):
    load_state(module, from_jax_params(jax.tree_util.tree_map(np.asarray, jax_params)))
    return module


def _trained(jax_module, npz, *example):
    return load_params(OFFLINE / npz, jax_module.init(jax.random.PRNGKey(0), *example))


@pytest.fixture(scope="module")
def trained_seg():
    seg_cfg, _ = jax_fixtures.offline_tiny_configs()
    jm = jax_pyannote.PyannoteSegmentation(seg_cfg)
    params = _trained(jm, "segmentation.npz", jnp.zeros((1, 160_000)))
    pm = port_pyannote.PyannoteSegmentation(port_fixtures.offline_tiny_configs()[0], device="cpu")
    load_state(pm, load_npz(OFFLINE / "segmentation.npz"))  # the DenseGeneral rule
    return jm, params, pm.eval()


@pytest.fixture(scope="module")
def trained_emb():
    _, emb_cfg = jax_fixtures.offline_tiny_configs()
    jm = jax_wespeaker.WeSpeakerEmbedder(emb_cfg)
    params = _trained(jm, "embedding.npz", jnp.zeros((1, 1001, 80)), jnp.ones((1, 589)))
    pm = port_wespeaker.WeSpeakerEmbedder(port_fixtures.offline_tiny_configs()[1], device="cpu")
    load_state(pm, load_npz(OFFLINE / "embedding.npz"))
    return jm, params, pm.eval()


# ---------------------------------------------------------------- segmentation


def test_trained_segmentation_npz_gives_jax_logits(trained_seg):
    """Loading `offline/segmentation.npz` (DenseGeneral attention kernels
    beside the [251, 1, 16] stem conv) gives JAX's logits and classes."""
    jm, params, pm = trained_seg
    wav = waves(0)
    want = np.asarray(jm.apply(params, wav))
    got = pm(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 589, 7)
    assert rel_l2(got, want) < REL_L2
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_array_equal(
        port_pyannote.powerset_to_binary(torch.from_numpy(got)).numpy(),
        np.asarray(jax_pyannote.powerset_to_binary(jnp.asarray(got))))


@pytest.mark.parametrize("arch", ["attention", "pyannet"])
def test_segmentation_at_full_width_matches_jax(arch):
    """The default attention arch and the upstream PyanNet (SincNet stem,
    4-layer BiLSTM) on seeded JAX weights mapped into the port."""
    jax_cls, port_cls = ((jax_pyannote.PyannoteSegmentation, port_pyannote.PyannoteSegmentation)
                         if arch == "attention" else (jax_pyannote.PyanNet, port_pyannote.PyanNet))
    jm = jax_cls()
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 160_000)))
    pm = _to_port(port_cls(device="cpu"), params).eval()
    wav = waves(1, 1)
    want = np.asarray(jm.apply(params, wav))
    got = pm(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (1, 589, 7)
    assert rel_l2(got, want) < REL_L2
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_powerset_binary_and_clean_mask_equal_jax():
    logits = np.random.RandomState(4).randn(3, 589, 7).astype(np.float32)
    binary = port_pyannote.powerset_to_binary(torch.from_numpy(logits)).numpy()
    want = np.asarray(jax_pyannote.powerset_to_binary(jnp.asarray(logits)))
    np.testing.assert_array_equal(binary, want)
    np.testing.assert_array_equal(
        port_pyannote.clean_frame_mask(torch.from_numpy(binary)).numpy(),
        np.asarray(jax_pyannote.clean_frame_mask(jnp.asarray(want))))


def test_offline_segmentation_processor_equals_jax(trained_seg):
    """Windows at stepRatio 0.2 over 23 s (the last window pinned to the
    end), cut on the device from one copy: the same starts, soft weights
    (within REL_L2) and binary as JAX's batched processor."""
    jm, params, pm = trained_seg
    rs = np.random.RandomState(5)
    mix, _, _ = jax_tc.diarizer_mixture(rs, 23.0)
    opts = SegmentationOptions()
    want = jax_seg.OfflineSegmentationProcessor(jm, params, opts).process(mix, batch_size=4)
    updates = []
    got = port_seg.OfflineSegmentationProcessor(pm, port_types.SegmentationOptions()).process(
        mix, batch_size=4, progress=lambda d, t: updates.append((d, t)))
    assert [c.start_seconds for c in got] == [c.start_seconds for c in want]
    assert updates[-1] == (len(want), len(want))
    for g, w in zip(got, want):
        assert rel_l2(g.weights, w.weights) < REL_L2
        np.testing.assert_array_equal(g.binary, w.binary)


# ------------------------------------------------------------------ embedding


def test_trained_embeddings_match_jax(trained_emb):
    jm, params, pm = trained_emb
    rs = np.random.RandomState(6)
    mel = rs.randn(3, 1001, 80).astype(np.float32)
    w = (rs.rand(3, 589) > 0.3).astype(np.float32)
    want = np.asarray(jm.apply(params, mel, w))
    got = pm(torch.from_numpy(mel), torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (3, 32)
    assert rel_l2(got, want) < REL_L2


def test_resnet34_embeddings_match_jax():
    """The full WeSpeaker ResNet34 (channels 32..256, 3/4/6/3 blocks) on
    seeded JAX weights: NCHW trunk, permuted to the JAX [S, T, F, C] order
    before the `embed` Dense."""
    jm = jax_wespeaker.WeSpeakerEmbedder()
    rs = np.random.RandomState(7)
    mel = rs.randn(1, 200, 80).astype(np.float32)
    w = (rs.rand(1, 117) > 0.5).astype(np.float32)  # resampled to the trunk's 25 frames
    params = jm.init(jax.random.PRNGKey(5), mel[:1], w[:1])
    pm = _to_port(port_wespeaker.WeSpeakerEmbedder(device="cpu"), params).eval()
    want = np.asarray(jm.apply(params, mel, w))
    got = pm(torch.from_numpy(mel), torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (1, 256)
    assert rel_l2(got, want) < REL_L2


def test_fbank_frontend_matches_jax():
    wav = waves(8, 1)
    want, _ = jax_wespeaker.make_fbank_frontend()(jnp.asarray(wav))
    got, _ = port_wespeaker.make_fbank_frontend("cpu")(torch.from_numpy(wav))
    assert got.shape == want.shape == (1, 80, 1001)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MEL_ATOL)


def test_embedding_extractor_equals_jax(trained_seg, trained_emb):
    """Per (window, speaker) jobs above the activity floor, overlap frames
    suppressed, weights interpolated to the fbank rate: the same index and
    embeddings (within REL_L2, each job's window cut on the device)."""
    jseg, jseg_p, pseg = trained_seg
    jemb, jemb_p, pemb = trained_emb
    rs = np.random.RandomState(9)
    mix, _, _ = jax_tc.diarizer_mixture(rs, 21.0)
    chunks = jax_seg.OfflineSegmentationProcessor(jseg, jseg_p, SegmentationOptions()).process(mix)
    want, want_idx = jax_emb.OfflineEmbeddingExtractor(
        jemb, jemb_p, jax_wespeaker.make_fbank_frontend(), EmbeddingOptions(batch_size=4),
    ).extract(mix, chunks)
    port_chunks = [port_seg.SegmentationChunk(c.start_seconds, c.weights, c.binary)
                   for c in chunks]
    got, got_idx = port_emb.OfflineEmbeddingExtractor(
        pemb, port_wespeaker.make_fbank_frontend("cpu"), port_types.EmbeddingOptions(batch_size=4),
    ).extract(mix, port_chunks)
    assert got_idx == want_idx and len(got_idx) > 4
    assert rel_l2(got, want) < REL_L2


@pytest.mark.parametrize("src,dst", [(589, 1001), (7, 3), (3, 8), (5, 5), (4, 0)])
def test_interpolate_weights_equals_jax(src, dst):
    w = np.random.RandomState(src * 31 + dst).rand(src).astype(np.float32)
    np.testing.assert_array_equal(port_emb.interpolate_weights(w, dst),
                                  jax_emb.interpolate_weights(w, dst))


# ----------------------------------------------------------------- clustering


def test_plda_equals_jax():
    """The trained fixture's fitted PLDA and the seeded random projection."""
    rs = np.random.RandomState(10)
    for jp, pp in ((jax_plda.PLDATransform.load(OFFLINE), port_plda.PLDATransform.load(OFFLINE)),
                   (jax_plda.PLDATransform.random_init(seed=3),
                    port_plda.PLDATransform.random_init(seed=3))):
        x = rs.randn(12, jp.mean.size).astype(np.float32)
        np.testing.assert_array_equal(pp.psi, jp.psi)
        np.testing.assert_array_equal(pp(x), jp(x))


def _blobs(seed: int, n_per: int, k: int, dim: int, scale: float = 0.6) -> tuple[np.ndarray, np.ndarray]:
    rs = np.random.RandomState(seed)
    centers = rs.randn(k, dim) * 2.0
    x = np.concatenate([rs.randn(n_per, dim) * scale + c for c in centers]).astype(np.float32)
    y = np.repeat(np.arange(k), n_per)
    warm = y.copy()
    flip = rs.choice(y.size, y.size // 6, replace=False)
    warm[flip] = rs.randint(0, k, flip.size)
    return x, warm


@pytest.mark.parametrize("case", [
    dict(seed=0, n_per=20, k=2, dim=16, opts=dict(fa=1.0, fb=1.0)),
    dict(seed=1, n_per=15, k=3, dim=32, opts=dict()),
    dict(seed=2, n_per=30, k=4, dim=8, opts=dict(fa=0.5, fb=0.8, loop_probability=0.95)),
])
def test_vbx_posteriors_and_labels_equal_jax(case):
    """VBx in f32 numpy against the jitted JAX iteration: the same labels,
    posteriors within GAMMA_ATOL, ELBO trace within ELBO_RTOL."""
    x, warm = _blobs(case["seed"], case["n_per"], case["k"], case["dim"])
    psi = np.linspace(4.0, 0.5, x.shape[1]).astype(np.float32)
    want = jax_vbx.VBxClustering(VBxOptions(**case["opts"])).refine(x, psi, warm)
    got = port_vbx.VBxClustering(port_types.VBxOptions(**case["opts"])).refine(x, psi, warm)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.gamma, want.gamma, atol=GAMMA_ATOL)
    np.testing.assert_allclose(got.pi, want.pi, atol=GAMMA_ATOL)
    assert len(got.elbo_trace) == len(want.elbo_trace)
    np.testing.assert_allclose(got.elbo_trace, want.elbo_trace, rtol=ELBO_RTOL)


@pytest.mark.parametrize("kw", [dict(num_speakers=1), dict(num_speakers=3),
                                dict(min_speakers=1, max_speakers=20)])
def test_vbx_constraints_equal_jax(kw):
    x, warm = _blobs(3, 20, 2, 16)
    psi = np.full(16, 4.0, np.float32)
    want = jax_vbx.VBxClustering().refine_with_constraints(x, psi, warm, **kw)
    got = port_vbx.VBxClustering().refine_with_constraints(x, psi, warm, **kw)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert (got.adjusted, got.original_cluster_count) == (want.adjusted,
                                                          want.original_cluster_count)


@pytest.mark.parametrize("seed,n,dim", [(0, 2, 4), (1, 17, 8), (2, 64, 32)])
def test_native_linkage_against_jax_and_scipy(seed, n, dim):
    """The port's fastcluster (built with the host compiler) gives JAX's
    dendrogram, and SciPy's centroid linkage, its plain version."""
    pts = np.random.RandomState(seed).randn(n, dim)
    got = port_fastcluster.centroid_linkage(pts)
    np.testing.assert_allclose(got, jax_fastcluster.centroid_linkage(pts), atol=1e-10)
    np.testing.assert_allclose(got, linkage(pts, method="centroid"), atol=1e-10)
    for t in (0.5, 1.5, 3.0):
        labels = port_fastcluster.cut_tree(got, n, t)
        np.testing.assert_array_equal(labels, jax_fastcluster.cut_tree(got, n, t))
        raw = fcluster(got, t=t, criterion="distance")
        _, first = np.unique(raw, return_index=True)
        order = {c: i for i, c in enumerate(raw[np.sort(first)])}
        np.testing.assert_array_equal(labels, [order[c] for c in raw])


@pytest.mark.parametrize("threshold", [0.05, jax_fixtures.OFFLINE_AHC_THRESHOLD, 0.6, 1.2])
def test_ahc_labels_equal_jax(threshold):
    x, _ = _blobs(4, 10, 3, 24, scale=1.0)
    np.testing.assert_array_equal(port_ahc.ahc_cluster(x, threshold),
                                  jax_ahc.ahc_cluster(x, threshold))


def test_fastcluster_build_is_keyed_and_a_failed_build_raises(tmp_path, monkeypatch):
    lib, _ = port_fastcluster.build_library()
    assert lib == port_fastcluster.library_path() and lib.exists()
    assert lib.parent.name == "_build" and lib.name.startswith("libfastcluster_")
    assert port_fastcluster.native_available()
    monkeypatch.setattr(port_fastcluster, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="fastcluster build failed"):
        port_fastcluster.build_library()
    assert not list(tmp_path.iterdir())
