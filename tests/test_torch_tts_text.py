"""The TTS text side of the PyTorch port against the JAX package.

`tts/{ssml,text_normalizer,phoneme_chunker,audio_post}.py` and the English
part of `tts/g2p.py` are copies of the JAX package's (they import no JAX).
Every case of `tests/test_ssml.py`, `test_tts_text.py`,
`test_english_normalizer.py`, `test_phoneme_chunker.py`, `test_tts_aux.py`
and the `TestEnglishG2PResolution` / `TestEnglishPhonemizerScenarios`
classes of `test_tts_g2p.py` runs against the port's modules (`jax_cases`,
each parametrized value set a case).

The BART OOV fallback (`models/bart_g2p.py`, `load_bart_fallback`): a seeded
JAX `BartG2P` init saved as `bart.npz` with a small HF `config.json` and a
`vocab.json` loads into both packages, whose fallbacks give the same
phonemes for a list of words; the decode's ids equal JAX's and its logits
agree within REL_L2 = 1e-5 (f32 reductions in another order).
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.models import bart_g2p as jax_bart
from fluidaudio_tpu.tts import g2p as jax_g2p
from fluidaudio_tpu.utils.checkpoint import save_params
from fluidaudio_tpu_torch.metrics import normalize_for_scoring
from fluidaudio_tpu_torch.models import bart_g2p as port_bart
from fluidaudio_tpu_torch.tts import g2p as port_g2p
from fluidaudio_tpu_torch.utils.weights import load_npz, load_state
from tests.test_torch_custom_vocab import jax_cases, one_torch_thread  # noqa: F401

REL_L2 = 1e-5

_TEXT_FILES = ("test_ssml.py", "test_tts_text.py", "test_english_normalizer.py",
               "test_phoneme_chunker.py", "test_tts_aux.py")
CASES = [c for f in _TEXT_FILES for c in jax_cases(f, ("tts",), fixtures=True, params=True)]
G2P_CASES = jax_cases("test_tts_g2p.py", ("tts",),
                      ("TestEnglishG2PResolution", "TestEnglishPhonemizerScenarios"),
                      fixtures=True, params=True)


@pytest.mark.parametrize("case", CASES + G2P_CASES)
def test_jax_tts_text_case_on_the_port(case, request):
    case(request)


def test_cases_cover_the_jax_suites():
    assert len(CASES) >= 150 and len(G2P_CASES) >= 15


WORDS = ["brillig", "slithy", "toves", "gyre", "gimble", "wabe", "a", "qzx"]


@pytest.fixture(scope="module")
def bart_dir(tmp_path_factory):
    """A seeded JAX `BartG2P` (BART_G2P_TEST) saved as the cache layout
    `load_bart_fallback` reads."""
    d = tmp_path_factory.mktemp("bart")
    cfg = jax_bart.BART_G2P_TEST
    model = jax_bart.BartG2P(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(5), jnp.zeros((1, 4), jnp.int32),
                                 jnp.ones((1, 4), bool), jnp.zeros((1, 2), jnp.int32))
    # a larger scale than flax's init so that the decode is not one token
    params = jax.tree_util.tree_map(lambda p: p * 4.0 if p.ndim == 2 else p, params)
    save_params(d / "bart.npz", params)
    (d / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    letters = "abcdefghijklmnopqrstuvwxyz'"
    ipa = "ɑæbdðeɛfɡhiɪjklmnŋoɔpɹsʃtθuʊvwzʒə"
    (d / "vocab.json").write_text(json.dumps({
        "grapheme_to_id": {c: 4 + i for i, c in enumerate(letters)},
        "id_to_phoneme": {str(4 + i): p for i, p in enumerate(ipa)},
        "unk_token_id": 3,
    }))
    return d, model, params


def test_bart_fallback_gives_jax_phonemes(bart_dir):
    d, _, _ = bart_dir
    want = jax_g2p.load_bart_fallback(d)
    got = port_g2p.load_bart_fallback(d, device="cpu")
    outs = [got(w) for w in WORDS]
    assert outs == [want(w) for w in WORDS]
    assert len({o for o in outs if o}) >= 3  # the decodes differ word to word


def test_bart_decode_ids_and_logits_equal_jax(bart_dir):
    d, model_j, params = bart_dir
    cfg = port_bart.config_from_hf(json.loads((d / "config.json").read_text()))
    model_p = port_bart.BartG2P(cfg, device="cpu").eval()
    load_state(model_p, load_npz(d / "bart.npz"))
    rs = np.random.RandomState(0)
    enc = rs.randint(4, 30, size=(3, 9)).astype(np.int32)
    enc[:, 0], enc[:, -1] = cfg.bos_token_id, cfg.eos_token_id
    mask = np.ones_like(enc, bool)
    mask[2, 6:] = False  # a padded row
    want_ids = np.asarray(jax_bart.bart_greedy_decode(model_j, params, jnp.asarray(enc),
                                                      jnp.asarray(mask), max_steps=12))
    got_ids = port_bart.bart_greedy_decode(model_p, torch.as_tensor(enc).long(),
                                           torch.as_tensor(mask), max_steps=12).numpy()
    np.testing.assert_array_equal(got_ids, want_ids)
    dec = np.concatenate([np.full((3, 1), cfg.decoder_start_token_id),
                          np.full((3, 1), cfg.bos_token_id), want_ids[:, :6]], 1)
    want = np.asarray(model_j.apply(params, jnp.asarray(enc), jnp.asarray(mask),
                                    jnp.asarray(dec.astype(np.int32))))
    with torch.no_grad():
        got = model_p(torch.as_tensor(enc).long(), torch.as_tensor(mask),
                      torch.as_tensor(dec).long()).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= REL_L2


def test_no_bart_cache_means_no_fallback(tmp_path):
    assert port_g2p.load_bart_fallback(tmp_path, device="cpu") is None


def test_normalize_for_scoring_is_jax_s():
    from fluidaudio_tpu.metrics import normalize_for_scoring as jax_norm

    for text in ("Hello, World!", "I can't  go — won't!", "Café ÉCLAIR's 3rd", ""):
        assert normalize_for_scoring(text) == jax_norm(text)
