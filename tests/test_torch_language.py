"""The `language=` decode filter of the PyTorch port against the JAX package.

The allowed-token mask (script match minus the English blocklist, built by
the port's copy of `utils/language.py`) must equal JAX `_language_mask` on
the trained `test-tiny` vocabulary, the placeholder vocabulary of the random
models and a mixed-script vocabulary. A filtered decode through
`build_pipeline(batch, language)` and `transcribe(..., language=...)` must
match JAX token for token; the trained fixture's vocabulary is swapped for
the mixed-script one on both sides so that the filter changes the tokens.
"""

import inspect
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fluidaudio_tpu.asr.config import ASRConfig as JaxASRConfig
from fluidaudio_tpu.asr.manager import AsrManager as JaxAsrManager
from fluidaudio_tpu.asr.tokenizer import Tokenizer as JaxTokenizer
from fluidaudio_tpu.models.zoo import AsrModels as JaxAsrModels
from fluidaudio_tpu.models.zoo import _placeholder_vocab as jax_placeholder_vocab
from fluidaudio_tpu.train.fixtures import trained_assets_dir
from fluidaudio_tpu.utils import language as jax_language
from fluidaudio_tpu_torch.asr.config import ASRConfig
from fluidaudio_tpu_torch.asr.manager import AsrManager
from fluidaudio_tpu_torch.asr.tokenizer import Tokenizer
from fluidaudio_tpu_torch.models.zoo import AsrModels, _placeholder_vocab
from fluidaudio_tpu_torch.train import tiny_corpus as tc
from fluidaudio_tpu_torch.utils import language

CKPT = trained_assets_dir() / "asr"
LANGUAGES = ["en", "es", "ru", "uk", "el", "ja", "zh", "ko"]


def _mixed_vocab(n: int) -> dict[int, str]:
    """Latin words, English blocklist words, Cyrillic, Greek, kana, kanji
    and a pure boundary marker, round robin over the ids."""
    pieces = ["▁w{}", "▁the", "▁слово{}", "▁λόγος", "▁ことば", "▁言葉", "▁", "{},"]
    return {i: pieces[i % len(pieces)].format(i) for i in range(n)}


def _vocabularies():
    trained = Tokenizer.from_json(CKPT / "vocab.json").vocabulary
    return {"trained": (trained, 64), "placeholder_v3": (_placeholder_vocab(8192), 8192),
            "mixed": (_mixed_vocab(64), 64)}


def _mask_owner(vocab, blank_id, device=None):
    models = SimpleNamespace(tokenizer=SimpleNamespace(vocabulary=vocab), blank_id=blank_id,
                             device=device)
    return SimpleNamespace(models=models, _language_masks={})


def test_language_module_copy_is_behaviour_identical():
    vocab = _mixed_vocab(200)
    for lang in LANGUAGES:
        a = jax_language.TokenLanguageFilter(lang, vocab)
        b = language.TokenLanguageFilter(lang, vocab)
        assert a.allowed == b.allowed and a.script.value == b.script.value
    assert _placeholder_vocab(300) == jax_placeholder_vocab(300)


@pytest.mark.parametrize("lang", LANGUAGES)
@pytest.mark.parametrize("vocab_name", ["trained", "placeholder_v3", "mixed"])
def test_language_mask_matches_jax(vocab_name, lang):
    vocab, blank_id = _vocabularies()[vocab_name]
    want = JaxAsrManager._language_mask(_mask_owner(vocab, blank_id), lang)
    owner = _mask_owner(vocab, blank_id, torch.device("cpu"))
    got = AsrManager._language_mask(owner, lang)
    assert got.dtype == torch.bool and tuple(got.shape) == (blank_id + 1,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert AsrManager._language_mask(owner, lang) is got  # built once per language


def test_build_pipeline_takes_the_jax_signature():
    names = lambda f: list(inspect.signature(f).parameters)
    assert names(AsrManager.build_pipeline) == names(JaxAsrManager.build_pipeline) == [
        "self", "batch", "language", "stateful"]
    assert names(AsrManager.transcribe)[:4] == names(JaxAsrManager.transcribe)[:4]


@pytest.fixture(scope="module")
def mixed_managers():
    """The trained fixture on both sides with the mixed-script vocabulary."""
    vocab = _mixed_vocab(64)
    jax_models = JaxAsrModels.load("test-tiny", checkpoint_dir=CKPT, allow_random_init=False)
    jax_models.tokenizer = JaxTokenizer(vocab)
    port_models = AsrModels.load("test-tiny", checkpoint_dir=CKPT, device="cpu",
                                 allow_random_init=False)
    port_models.tokenizer = Tokenizer(vocab)
    return (JaxAsrManager(jax_models, JaxASRConfig(parallel_chunk_batch=2)),
            AsrManager(port_models, ASRConfig(parallel_chunk_batch=2)))


def _utterances():
    rs = np.random.RandomState(12345)  # the draws of eval_asr_fixture
    out = []
    for n in (5, 40):
        ids = rs.randint(0, tc.N_WORDS, size=n)
        out.append(tc.make_utterance(ids, rs))
    return out


@pytest.mark.parametrize("lang", ["ru", "es", "ja"])
def test_filtered_pipeline_is_token_exact(mixed_managers, lang):
    """`build_pipeline(2, lang)` (language positional, as in JAX) on a ragged
    batch: the same tokens, times, durations and confidences as JAX, and
    the filter moved tokens (an unfiltered decode differs)."""
    jax_mgr, port_mgr = mixed_managers
    short, long = _utterances()
    W = 64_000
    rows = [short[:W], long[16_000:16_000 + 50_000]]
    audio = np.zeros((2, W), np.float32)
    lengths = np.array([len(r) for r in rows], np.int32)
    for i, r in enumerate(rows):
        audio[i, : len(r)] = r
    finalize = np.array([True, False])
    want, _ = jax.jit(jax_mgr.build_pipeline(2, lang))(
        jax_mgr.models.params, jnp.asarray(audio), jnp.asarray(lengths), jnp.asarray(finalize))
    got, _ = port_mgr.build_pipeline(2, lang)(
        torch.from_numpy(audio), torch.from_numpy(lengths), torch.from_numpy(finalize))
    for field in ("tokens", "token_times", "counts", "durations"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    # f32 joint logits summed in another order: confidences to 1e-5
    np.testing.assert_allclose(got.confidences.numpy(), np.asarray(want.confidences), atol=1e-5)
    plain, _ = port_mgr.build_pipeline(2)(
        torch.from_numpy(audio), torch.from_numpy(lengths), torch.from_numpy(finalize))
    assert not torch.equal(plain.tokens, got.tokens)
    allowed = port_mgr._language_mask(lang)
    emitted = [int(t) for r in range(2) for t in got.tokens[r, : int(got.counts[r])]]
    assert emitted and any(bool(allowed[t]) for t in emitted)


@pytest.mark.parametrize("lang", ["ru", "en"])
def test_transcribe_with_language_matches_jax(mixed_managers, lang):
    """One window and the chunked path (40 words), filtered."""
    jax_mgr, port_mgr = mixed_managers
    for audio in _utterances():
        want = jax_mgr.transcribe(audio, language=lang)
        got = port_mgr.transcribe(audio, language=lang)
        assert got.text == want.text
        assert [t.token_id for t in got.token_timings] == [
            t.token_id for t in want.token_timings]
