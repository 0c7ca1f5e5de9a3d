"""Nemotron streaming ASR of the PyTorch port against the JAX manager.

On the trained multilingual `nemotron` fixture
(`fluidaudio_tpu/assets/trained_tiny/nemotron`: two synthetic languages, tags
<aa-AA>/<bb-BB>, prompts {auto: 0, aa-AA: 1, bb-BB: 2}), the port's
`StreamingNemotronAsrManager` and the JAX one take the utterances of
`train/fixtures.eval_nemotron_fixture` (560 ms tier) with the language's
prompt and in auto mode, and must give the same text, token ids, timestamps
and detected language, exactly. Then, on the port: the fixture's WER and
language-detection gates, forced-prefix decoding, prompt switching, the
language-tag filter, the tier table, the asset-folder search, and the
metadata cases of `tests/test_nemotron.py` against the JAX parser.
"""

import json
from dataclasses import replace

import numpy as np
import pytest
import torch

from fluidaudio_tpu.asr import streaming_nemotron as jax_nem
from fluidaudio_tpu.train import fixtures as fx
from fluidaudio_tpu_torch.asr import streaming_nemotron as port_nem
from fluidaudio_tpu_torch.metrics.wer import wer
from fluidaudio_tpu_torch.models.conformer_streaming import StreamingConformerConfig
from fluidaudio_tpu_torch.registry import Repo
from fluidaudio_tpu_torch.train import tiny_corpus as tc
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

CKPT = fx.trained_assets_dir() / "nemotron"
# the fixture's encoder size (fixtures.nemotron_tiny_enc_cfg)
TINY_ENC = StreamingConformerConfig(d_model=64, n_layers=2, n_heads=4, subsampling_channels=32,
                                    att_context_left=16)
WER_GATE = 0.02


def _utterances(seed=9753, n=6):
    """The draws of `eval_nemotron_fixture`: (language, reference, audio)."""
    rs = np.random.RandomState(seed)
    out = []
    for u in range(n):
        lang = "a" if u % 2 == 0 else "b"
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 8)))
        audio = tc.make_utterance(ids, rs, lang=lang)
        words = (tc.word_text(i) if lang == "a" else tc.word_text_b(i) for i in ids)
        out.append(("aa-AA" if lang == "a" else "bb-BB", " ".join(words), audio))
    return out


UTTS = _utterances()


def port_manager(language="auto", **kw):
    return port_nem.StreamingNemotronAsrManager(
        port_nem.NEMOTRON_TEST, 560, language=language, enc_cfg=TINY_ENC,
        checkpoint_dir=CKPT, device="cpu", **kw)


@pytest.fixture(scope="module")
def managers():
    jax_mgr = jax_nem.StreamingNemotronAsrManager(
        jax_nem.NEMOTRON_TEST, 560, language="auto", enc_cfg=fx.nemotron_tiny_enc_cfg(),
        checkpoint_dir=CKPT)
    return jax_mgr, port_manager()


def _run(mgr, audio, language, **state_kw):
    mgr.set_language(language)
    state = mgr.make_state(**state_kw)
    mgr.process(audio, state)
    return state, mgr.finish(state)


@pytest.mark.parametrize("mode", ["prompted", "auto"])
@pytest.mark.parametrize("u", range(len(UTTS)))
def test_trained_fixture_matches_jax(managers, u, mode):
    lang, ref, audio = UTTS[u]
    language = lang if mode == "prompted" else "auto"
    jax_mgr, mgr = managers
    js, jf = _run(jax_mgr, audio, language)
    ps, pf = _run(mgr, audio, language)
    assert mgr.prompt_id == jax_mgr.prompt_id
    assert pf.text == jf.text
    assert pf.token_ids == jf.token_ids and pf.timestamps_ms == jf.timestamps_ms
    assert ps.detected_language == js.detected_language
    if mode == "prompted":
        assert pf.text == ref
    else:
        assert ps.detected_language == lang


def test_trained_fixture_gates():
    """`eval_nemotron_fixture` through the port: WER <= 0.02 with the
    language's prompt, and the auto mode detects each language."""
    mgr = port_manager()
    rates, detected = [], 0
    for lang, ref, audio in UTTS:
        _, final = _run(mgr, audio, lang)
        rates.append(wer(ref, final.text).rate)
        state, _ = _run(mgr, audio, "auto")
        detected += state.detected_language == lang
    assert np.mean(rates) <= WER_GATE
    assert detected / len(UTTS) >= 0.99


def test_forced_prefix_gives_the_bb_text(managers):
    """Seeding the decoder with the <bb-BB> tag (the hard language lock)."""
    jax_mgr, mgr = managers
    rs = np.random.RandomState(91)
    ids = rs.randint(0, tc.N_WORDS, size=4)
    audio = tc.make_utterance(ids, rs, lang="b")
    tag = mgr.lang_tag_token("bb-BB")
    assert tag == jax_mgr.lang_tag_token("bb-BB") == fx.NEMOTRON_TAG_B
    assert mgr.lang_tag_token("bb_bb") == tag and mgr.lang_tag_token("zz-ZZ") is None
    _, final = _run(mgr, audio, "auto", forced_prefix=tag)
    _, want = _run(jax_mgr, audio, "auto", forced_prefix=tag)
    assert "<" not in final.text
    assert final.text == " ".join(tc.word_text_b(int(i)) for i in ids)
    assert final.token_ids == want.token_ids and final.timestamps_ms == want.timestamps_ms


def test_prompt_switching():
    mgr = port_manager("aa-AA")
    assert mgr.prompt_id == 1
    mgr.set_language("bb-BB")
    assert mgr.prompt_id == 2 and mgr.detected_language is None
    mgr.set_language(None)
    assert mgr.prompt_id == 0 and mgr.language == "auto"


def test_lang_tags_filtered_on_random_weights(tmp_path):
    """Tag ids never reach the transcript (a random tiny latin pack)."""
    (tmp_path / "metadata.json").write_text(json.dumps({
        "prompt_dictionary": {"auto": 5, "de-DE": 2}, "default_prompt_id": 5,
        "num_prompts": 8, "lang_tag_token_ids": [3],
    }))
    mgr = port_nem.StreamingNemotronAsrManager(
        replace(port_nem.NEMOTRON_MULTI_LATIN, vocab_size=32), chunk_ms=1120,
        language="de-DE", checkpoint_dir=tmp_path, enc_cfg=StreamingConformerConfig(
            d_model=64, n_layers=2, n_heads=4, subsampling_channels=16), device="cpu")
    assert mgr.prompt_id == 2 and mgr.encoder.prompt_embed.shape == (8, 64)
    state = mgr.make_state()
    rng = np.random.RandomState(0)
    mgr.process(rng.randn(mgr.chunk_samples + 400).astype(np.float32) * 0.1, state)
    assert 3 not in state.tokens


def test_tier_chunking_english_spec():
    tiny_en = port_nem.NemotronSpec("tiny-en", Repo.NEMOTRON_EN, vocab_size=32, d_model=64,
                                    n_layers=2)
    mgr = port_nem.StreamingNemotronAsrManager(
        tiny_en, chunk_ms=560, enc_cfg=StreamingConformerConfig(
            d_model=64, n_layers=2, n_heads=4, att_context_left=16, subsampling_channels=16),
        device="cpu")
    assert mgr.chunk_samples == 8960 and mgr.prompt_id == 0
    assert "prompt_embed" not in mgr.encoder.state_dict()
    state = mgr.make_state()
    rng = np.random.RandomState(0)
    assert len(mgr.process((rng.randn(20_000) * 0.1).astype(np.float32), state)) == 2
    final = mgr.finish(state)
    assert isinstance(final.text, str) and final.is_final
    assert port_nem.NEMOTRON_TIERS_MS == jax_nem.NEMOTRON_TIERS_MS == (560, 1120, 2240)
    with pytest.raises(ValueError, match="chunk_ms"):
        port_nem.StreamingNemotronAsrManager(tiny_en, chunk_ms=320, device="cpu")


def test_specs_and_locales_match_jax():
    for name in ("NEMOTRON_EN", "NEMOTRON_MULTI_LATIN", "NEMOTRON_MULTI_FULL",
                 "NEMOTRON_TEST"):
        p, j = getattr(port_nem, name), getattr(jax_nem, name)
        assert (p.name, p.vocab_size, p.d_model, p.n_layers, p.multilingual, p.pred_hidden,
                p.joint_hidden) == (j.name, j.vocab_size, j.d_model, j.n_layers,
                                    j.multilingual, j.pred_hidden, j.joint_hidden)
        assert p.repo.name == j.repo.name and p.repo.folder_name == j.repo.folder_name
    assert port_nem.NEMOTRON_LOCALES == jax_nem.NEMOTRON_LOCALES


@pytest.mark.parametrize("code", ["en_us", "cmn_hans_cn", "es_419", "pt_br", "ar_eg",
                                  "de_de", "weird", "a_b_c"])
def test_fleurs_codes_match_jax(code):
    assert port_nem.fleurs_to_multilingual_language(code) == \
        jax_nem.fleurs_to_multilingual_language(code)


def test_asset_folder_search(tmp_path, monkeypatch):
    """Per-tier, then per-language subfolders; the root when none holds an
    encoder; no folder means the model cache's `spec.repo` folder, as in JAX."""
    for sub in ("560ms", "bb/560ms", "bb"):
        (tmp_path / sub).mkdir(parents=True, exist_ok=True)
    (tmp_path / "560ms" / "encoder.npz").write_bytes(b"")
    mgr = port_nem.StreamingNemotronAsrManager.__new__(port_nem.StreamingNemotronAsrManager)
    mgr.spec, mgr.chunk_ms, mgr.language = port_nem.NEMOTRON_TEST, 560, "auto"
    assert mgr._resolve_base(tmp_path) == tmp_path / "560ms"
    mgr.language = "bb-BB"
    assert mgr._resolve_base(tmp_path) == tmp_path / "560ms"
    (tmp_path / "bb" / "encoder.npz").write_bytes(b"")
    assert mgr._resolve_base(tmp_path) == tmp_path / "bb"
    (tmp_path / "bb" / "560ms" / "encoder.npz").write_bytes(b"")
    assert mgr._resolve_base(tmp_path) == tmp_path / "bb" / "560ms"
    mgr.chunk_ms = 1120
    assert mgr._resolve_base(tmp_path) == tmp_path / "bb"
    monkeypatch.setenv("FLUID_CACHE_DIR", str(tmp_path / "cache"))
    assert mgr._resolve_base(None) == tmp_path / "cache" / "Models" / "nemotron-multilingual"


def test_no_metadata_falls_back_to_the_locale_table(tmp_path):
    mgr = port_nem.StreamingNemotronAsrManager(
        replace(port_nem.NEMOTRON_TEST, vocab_size=20), 560, language="fr",
        enc_cfg=TINY_ENC, checkpoint_dir=tmp_path, device="cpu")
    assert mgr.metadata.num_prompts == 128
    assert mgr.prompt_id == port_nem.NEMOTRON_LOCALES["fr"]


def test_default_device_is_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_nem.StreamingNemotronAsrManager(port_nem.NEMOTRON_TEST, 560, enc_cfg=TINY_ENC,
                                             checkpoint_dir=CKPT)


# ------------------------------------------- metadata (tests/test_nemotron.py:136-231)

METADATA_FILES = {
    "full": json.dumps({"num_prompts": 64, "default_prompt_id": 7,
                        "prompt_dictionary": {"en-US": 1, "de-DE": 2},
                        "lang_tag_token_ids": [5, 6]}),
    "partial": '{"num_prompts": 32}',
    "empty": "{}",
    "wrong_types": ('{"num_prompts": "many", "default_prompt_id": true,'
                    ' "prompt_dictionary": [1], "lang_tag_token_ids": {"a": 1}}'),
    "resolution": json.dumps({"num_prompts": 128, "default_prompt_id": 101,
                              "prompt_dictionary": {"auto": 101, "en-US": 3, "zh-CN": 7,
                                                    "de-DE": 9},
                              "lang_tag_token_ids": [13000, 13001]}),
}


def _fields(m):
    return (m.num_prompts, m.default_prompt_id, m.prompt_dictionary, m.lang_tag_token_ids)


@pytest.mark.parametrize("case", sorted(METADATA_FILES))
def test_metadata_loads_like_jax(tmp_path, case):
    path = tmp_path / "metadata.json"
    path.write_text(METADATA_FILES[case])
    got = port_nem.NemotronMultilingualMetadata.load(path)
    assert _fields(got) == _fields(jax_nem.NemotronMultilingualMetadata.load(path))
    for lang in (None, "", "auto", "en-US", "en_us", "EN-us", "zh", "de", "xx-YY"):
        assert got.prompt_id(lang) == jax_nem.NemotronMultilingualMetadata.load(
            path).prompt_id(lang), (case, lang)


@pytest.mark.parametrize("content,error,match", [
    ("{not json", ValueError, None),
    ("[1, 2]", ValueError, "object"),
    (None, OSError, None),
], ids=["invalid_json", "array_root", "missing_file"])
def test_metadata_load_raises(tmp_path, content, error, match):
    path = tmp_path / "metadata.json"
    if content is not None:
        path.write_text(content)
    with pytest.raises(error, match=match):
        port_nem.NemotronMultilingualMetadata.load(path)


@pytest.mark.parametrize("language,want", [
    ("en-US", 1), (None, 101), ("", 101), ("en_US", 1), ("EN-us", 1), ("de", 2), ("pt", 3),
    ("xx-YY", 101),
])
def test_prompt_id_resolution(language, want):
    d = {"en-US": 1, "de-DE": 2, "pt-BR": 3, "auto": 101}
    got = port_nem.NemotronMultilingualMetadata(prompt_dictionary=dict(d)).prompt_id(language)
    assert got == want == jax_nem.NemotronMultilingualMetadata(
        prompt_dictionary=dict(d)).prompt_id(language)
