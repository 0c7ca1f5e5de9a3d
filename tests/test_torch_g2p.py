"""The G2P slice of the PyTorch port against the JAX package.

- `models/g2p_seq2seq.py`: `g2p_greedy_decode` token-exact against JAX's
  `lax.scan` on JAX's seeded init (ragged words, three seeds), and a
  finished row keeps JAX's semantics (it stops advancing and writes PAD over
  its EOS);
- `models/byt5_g2p.py`: `relative_position_bucket` equal to JAX's for every
  relative position in -max..max (and past it) at BYT5_TEST's and
  BYT5_SMALL's bucket settings, both directions; `byt5_greedy_decode`
  token-exact; a tied head's rescale;
- `models/bert_g2pw.py`: the logits within REL_L2 of JAX's on a masked
  batch;
- `tts/g2p.py::MultilingualG2P` on JAX's seq2seq parameters and on a saved
  ByT5 checkpoint: the same phoneme strings;
- `tts/mandarin_g2p.py::MandarinG2pw` from a saved checkpoint directory:
  logits within REL_L2 and the same picks; `MandarinG2P` and
  `MandarinJiebaHmm` on the same paragraph: the same bopomofo;
- the cases of `tests/test_mandarin_g2p.py` and `tests/test_mandarin_numbers.py`,
  `test_g2p_model.py::test_encode_word` and the multilingual cases of
  `tests/test_tts_g2p.py`, run on the port (`jax_cases`). The other two cases
  of `test_g2p_model.py` drive a flax module's `init`/`apply` protocol; their
  port counterparts are `test_greedy_decode_shapes_and_bos` and
  `test_language_prefix_is_the_first_source_token` here.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.models import bert_g2pw as jw
from fluidaudio_tpu.models import byt5_g2p as jb
from fluidaudio_tpu.models import g2p_seq2seq as jg
from fluidaudio_tpu.tts import g2p as jax_g2p
from fluidaudio_tpu.tts import mandarin_g2p as jax_mg
from fluidaudio_tpu.utils.checkpoint import save_params
from fluidaudio_tpu_torch.models import bert_g2pw as pw
from fluidaudio_tpu_torch.models import byt5_g2p as pb
from fluidaudio_tpu_torch.models import g2p_seq2seq as pg
from fluidaudio_tpu_torch.tts import g2p as port_g2p
from fluidaudio_tpu_torch.tts import mandarin_g2p as port_mg
from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_state
from tests.test_torch_custom_vocab import jax_cases, jax_fixtures, one_torch_thread  # noqa: F401

REL_L2 = 1e-5
WORDS = ["hello", "cat", "données", "x", "straße", "anticonstitutionnellement"]
PARAGRAPH = "银行的行长说，这个月的利率不会变。重庆的朋友长得很高，他们还没了解。"


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _seq2seq(seed: int):
    model = jg.G2pSeq2Seq(jg.G2P_TEST)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, jg.MAX_WORD_BYTES),
                                                                    jnp.int32),
                                 jnp.ones((1,), jnp.int32), jnp.zeros((1, 4), jnp.int32))
    port = pg.G2pSeq2Seq(pg.G2P_TEST, device="cpu").eval()
    load_state(port, from_jax_params(_np(params)))
    return model, params, port


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seq2seq_greedy_decode_is_token_exact(seed):
    model, params, port = _seq2seq(seed)
    rows, lens = zip(*(jg.encode_word(w, language_prefix=seed + 3) for w in WORDS))
    b, n = np.stack(rows), np.array(lens, np.int32)
    want_tok, want_pos = jg.g2p_greedy_decode(model, params, jnp.asarray(b), jnp.asarray(n))
    got_tok, got_pos = pg.g2p_greedy_decode(port, torch.as_tensor(b).long(),
                                            torch.as_tensor(n).long())
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    # teacher-forced logits too
    tgt = np.asarray(want_tok)
    want = model.apply(params, jnp.asarray(b), jnp.asarray(n), jnp.asarray(tgt))
    got = port(torch.as_tensor(b).long(), torch.as_tensor(n).long(), torch.as_tensor(tgt))
    assert _rel(got.detach().numpy(), want) <= REL_L2


def test_finished_row_writes_pad_over_its_eos():
    """With the head's EOS logit raised, every row ends at step 1: JAX's scan
    then writes PAD at the row's (frozen) position on every later step."""
    model, params, port = _seq2seq(0)
    params = _np(params)
    params["params"]["head"]["bias"][jg.EOS] = 1e3
    with torch.no_grad():
        port.head.bias[pg.EOS] = 1e3
    rows, lens = zip(*(jg.encode_word(w) for w in WORDS[:3]))
    b, n = np.stack(rows), np.array(lens, np.int32)
    want_tok, want_pos = jg.g2p_greedy_decode(model, params, jnp.asarray(b), jnp.asarray(n))
    got_tok, got_pos = pg.g2p_greedy_decode(port, torch.as_tensor(b).long(),
                                            torch.as_tensor(n).long())
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    assert (got_pos.numpy() == 1).all() and (got_tok.numpy()[:, 1:] == pg.PAD).all()


def test_greedy_decode_shapes_and_bos():
    _, _, port = _seq2seq(0)
    rows, lens = zip(pg.encode_word("hello"), pg.encode_word("cat"))
    tokens, counts = pg.g2p_greedy_decode(port, torch.as_tensor(np.stack(rows)).long(),
                                          torch.as_tensor(np.array(lens)).long())
    assert tokens.shape == (2, pg.MAX_PHONEMES)
    assert (tokens[:, 0] == pg.BOS).all() and (counts <= pg.MAX_PHONEMES).all()


def test_language_prefix_is_the_first_source_token():
    for prefix in (1, 2):
        row, n = pg.encode_word("data", language_prefix=prefix)
        want = jg.encode_word("data", language_prefix=prefix)
        assert row[0] == 256 + prefix and n == 5
        np.testing.assert_array_equal(row, want[0])


@pytest.mark.parametrize("cfg", [jb.BYT5_TEST, jb.BYT5_SMALL], ids=["test", "small"])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_buckets_equal_jax(cfg, bidirectional):
    """Every relative position in -max..max, and 3x past it, at the
    config's bucket count and distance: equal to JAX's float-log buckets."""
    span = 3 * cfg.relative_attention_max_distance
    rel = np.arange(-span, span + 1, dtype=np.int32)
    kw = dict(bidirectional=bidirectional, num_buckets=cfg.relative_attention_num_buckets,
              max_distance=cfg.relative_attention_max_distance)
    want = np.asarray(jb.relative_position_bucket(jnp.asarray(rel), **kw))
    got = pb.relative_position_bucket(torch.as_tensor(rel), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    # and as a [Tq, Tk] grid (the attention's own call)
    T = cfg.relative_attention_max_distance + 5
    grid = np.arange(T)[None, :] - np.arange(T)[:, None]
    np.testing.assert_array_equal(
        pb.relative_position_bucket(torch.as_tensor(grid), **kw).numpy(),
        np.asarray(jb.relative_position_bucket(jnp.asarray(grid, jnp.int32), **kw)))


def _byt5(cfg=jb.BYT5_TEST, seed=0):
    model = jb.ByT5G2P(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
                                 jnp.ones((1, 8), bool), jnp.zeros((1, 4), jnp.int32))
    port = pb.ByT5G2P(pb.ByT5Config(**vars(cfg)), device="cpu").eval()
    load_state(port, from_jax_params(_np(params)))
    return model, params, port


@pytest.mark.parametrize("tied", [False, True])
def test_byt5_greedy_decode_is_token_exact(tied):
    import dataclasses

    cfg = dataclasses.replace(jb.BYT5_TEST, tie_word_embeddings=tied)
    model, params, port = _byt5(cfg, seed=int(tied))
    rows = np.stack([jb.encode_bytes(f"<fra>: {w}", 36)[0] for w in WORDS])
    want = np.asarray(jb.byt5_greedy_decode(model, params, jnp.asarray(rows),
                                            jnp.asarray(rows != 0), max_steps=20))
    got = pb.byt5_greedy_decode(port, torch.as_tensor(rows).long(),
                                torch.as_tensor(rows != 0), max_steps=20).numpy()
    np.testing.assert_array_equal(got, want)
    dec = np.concatenate([np.zeros((len(WORDS), 1), np.int32), want[:, :-1]], axis=1)
    logits_w = model.apply(params, jnp.asarray(rows), jnp.asarray(rows != 0), jnp.asarray(dec))
    logits_g = port(torch.as_tensor(rows).long(), torch.as_tensor(rows != 0),
                    torch.as_tensor(dec).long())
    assert _rel(logits_g.detach().numpy(), logits_w) <= REL_L2
    assert pb.decode_bytes(got[0]) == jb.decode_bytes(want[0])


def test_byt5_config_from_hf_is_jax_s():
    from fluidaudio_tpu.convert.byt5 import config_from_hf

    payload = {"vocab_size": 384, "d_model": 1472, "d_kv": 64, "d_ff": 3584,
               "num_layers": 12, "num_decoder_layers": 4, "num_heads": 6}
    assert vars(pb.config_from_hf(payload)) == vars(config_from_hf(payload))
    assert vars(pb.BYT5_SMALL) == vars(jb.BYT5_SMALL)


def test_bert_logits_equal_jax():
    model = jw.BertG2pw(jw.G2PW_TEST)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 128, (3, 20)).astype(np.int32)
    mask = np.ones((3, 20), bool)
    mask[2, 15:] = False
    types = np.zeros((3, 20), np.int32)
    pos = np.array([1, 5, 9], np.int32)
    args = [jnp.asarray(a) for a in (ids, mask, types, pos)]
    params = model.init(jax.random.PRNGKey(1), *args)
    want = np.asarray(model.apply(params, *args))
    port = pw.BertG2pw(pw.G2PW_TEST, device="cpu").eval()
    load_state(port, from_jax_params(_np(params)))
    got = port(*(torch.as_tensor(a) for a in (ids, mask, types, pos))).numpy()
    assert got.shape == want.shape and _rel(got, want) <= REL_L2


def test_bert_config_from_hf_is_jax_s():
    from fluidaudio_tpu.convert.g2pw import config_from_hf

    payload = {"vocab_size": 21128, "hidden_size": 768, "num_hidden_layers": 12,
               "num_attention_heads": 12, "intermediate_size": 3072,
               "max_position_embeddings": 512}
    assert vars(pw.config_from_hf(payload)) == vars(config_from_hf(payload))
    assert vars(pw.config_from_hf(payload, 9)) == vars(config_from_hf(payload, 9))
    assert vars(pw.G2PW_BASE) == vars(jw.G2PW_BASE)


# ------------------------------------------------------------ the frontends


def test_multilingual_g2p_equals_jax_on_its_parameters():
    jm = jax_g2p.MultilingualG2P()
    pm = port_g2p.MultilingualG2P(params=_np(jm.params), device="cpu")
    for lang in ("fra", "eng-us", "cmn"):
        assert pm.phonemize_words(WORDS, lang) == jm.phonemize_words(WORDS, lang)
    text = "Hello, world! don't stop"
    assert pm.phonemize(text) == jm.phonemize(text)


def test_multilingual_g2p_byt5_checkpoint_equals_jax(tmp_path):
    model, params, _ = _byt5(seed=3)
    save_params(tmp_path / "byt5.npz", params)
    cfg = {k: v for k, v in vars(jb.BYT5_TEST).items() if k != "layer_norm_epsilon"}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    jm = jax_g2p.MultilingualG2P(checkpoint_dir=tmp_path)
    pm = port_g2p.MultilingualG2P(checkpoint_dir=tmp_path, device="cpu")
    assert pm.byt5 is not None and pm.model is None
    assert pm.phonemize_words(WORDS, "fra") == jm.phonemize_words(WORDS, "fra")
    np.testing.assert_array_equal(
        pm.decode_ids(WORDS[:2], "deu"),
        np.asarray(jb.byt5_greedy_decode(
            jm.byt5, jm.byt5_params,
            jnp.asarray(np.stack([jb.encode_bytes(f"<deu>: {w}", 15)[0] for w in WORDS[:2]])),
            jnp.asarray(np.stack([jb.encode_bytes(f"<deu>: {w}", 15)[0] for w in WORDS[:2]])
                        != 0))))


def _g2pw_dir(tmp_path):
    """A g2pW checkpoint directory: JAX's G2PW_TEST init, a vocab over the
    paragraph's characters and a catalog of its polyphones."""
    model = jw.BertG2pw(jw.G2PW_TEST)
    params = jax.jit(model.init)(jax.random.PRNGKey(5), jnp.zeros((1, 4), jnp.int32),
                                 jnp.ones((1, 4), bool), jnp.zeros((1, 4), jnp.int32),
                                 jnp.zeros((1,), jnp.int32))
    save_params(tmp_path / "g2pw.npz", params)
    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 128, "hidden_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 64,
        "max_position_embeddings": 64, "num_labels": 16}))
    vocab = ["[PAD]"] * 128
    vocab[100], vocab[101], vocab[102] = "[UNK]", "[CLS]", "[SEP]"
    for i, ch in enumerate(sorted(set(PARAGRAPH))[:90]):
        vocab[3 + i] = ch
    (tmp_path / "vocab.txt").write_text("\n".join(vocab), encoding="utf-8")
    catalog = {"行": {"xing2": 1, "hang2": 2}, "长": {"chang2": 3, "zhang3": 4},
               "重": {"zhong4": 5, "chong2": 6}, "得": {"de5": 7, "dei3": 8},
               "了": {"le5": 9, "liao3": 10}, "还": {"hai2": 11, "huan2": 12}}
    (tmp_path / "polyphone_catalog.json").write_text(json.dumps(catalog, ensure_ascii=False),
                                                     encoding="utf-8")
    return tmp_path


def test_mandarin_g2pw_equals_jax(tmp_path):
    base = _g2pw_dir(tmp_path)
    jg2pw = jax_mg.MandarinG2pw.load(base)
    pg2pw = port_mg.MandarinG2pw.load(base, device="cpu")
    targets = [i for i, ch in enumerate(PARAGRAPH) if ch in pg2pw.catalog]
    assert len(targets) >= 6
    ids = [jg2pw.char_to_id.get("[CLS]")] + [jg2pw.char_to_id.get(c, 100) for c in PARAGRAPH] \
        + [jg2pw.char_to_id.get("[SEP]")]
    B = len(targets)
    want = np.asarray(jg2pw.model.apply(
        jg2pw.params, jnp.asarray(np.tile(np.asarray(ids, np.int32), (B, 1))),
        jnp.ones((B, len(ids)), bool), jnp.zeros((B, len(ids)), jnp.int32),
        jnp.asarray([t + 1 for t in targets], jnp.int32)))
    got = pg2pw.logits(PARAGRAPH, targets)
    assert _rel(got, want) <= REL_L2
    assert pg2pw.disambiguate(PARAGRAPH, targets) == jg2pw.disambiguate(PARAGRAPH, targets)
    jm = jax_mg.MandarinG2P(g2pw=jg2pw)
    pm = port_mg.MandarinG2P(g2pw=pg2pw)
    assert pm.phonemize_bopomofo(PARAGRAPH) == jm.phonemize_bopomofo(PARAGRAPH)
    assert pm.phonemize(PARAGRAPH) == jm.phonemize(PARAGRAPH)


def test_mandarin_g2p_and_jieba_hmm_equal_jax():
    """The seed-lexicon MandarinG2P, and MandarinG2P over a Jieba HMM whose
    tables favour words across the paragraph's characters: the same
    bopomofo and pinyin."""
    assert port_mg.MandarinG2P().phonemize_bopomofo(PARAGRAPH) == \
        jax_mg.MandarinG2P().phonemize_bopomofo(PARAGRAPH)
    rs = np.random.RandomState(6)
    chars = sorted(set(PARAGRAPH))
    tables = dict(start=[0.0, -100.0, -100.0, -0.5],
                  trans=[[-100.0, -1.0, -0.3, -100.0], [-100.0, -1.0, -0.4, -100.0],
                         [-0.4, -100.0, -100.0, -1.0], [-0.5, -100.0, -100.0, -0.9]],
                  emit={c: list(rs.uniform(-3.0, 0.0, 4)) for c in chars})
    jm = jax_mg.MandarinG2P(jieba_hmm=jax_mg.MandarinJiebaHmm(jax_mg.JiebaHmmTables(**tables)))
    pm = port_mg.MandarinG2P(
        jieba_hmm=port_mg.MandarinJiebaHmm(port_mg.JiebaHmmTables(**tables)))
    assert pm.phonemize_bopomofo(PARAGRAPH) == jm.phonemize_bopomofo(PARAGRAPH)
    assert pm.phonemize(PARAGRAPH) == jm.phonemize(PARAGRAPH)


# ------------------------------------------------- the JAX suites' own cases

G2PW_EDITS = (("MandarinG2pw.load(tmp_path)", 'MandarinG2pw.load(tmp_path, device="cpu")'),)
MANDARIN_CASES = jax_cases("test_mandarin_g2p.py", ("tts",), edits=G2PW_EDITS, fixtures=True,
                           params=True)
NUMBER_CASES = jax_cases("test_mandarin_numbers.py", ("tts",), fixtures=True, params=True)
MODEL_CASES = jax_cases("test_g2p_model.py", ("models.g2p_seq2seq",), ("test_encode_word",))
MULTILINGUAL_CASES = jax_cases(
    "test_tts_g2p.py", ("tts",), ("TestMultilingualG2P", "test_multilingual_g2p_byt5"),
    edits=(("return MultilingualG2P()", 'return MultilingualG2P(device="cpu")'),
           ("g2p = MultilingualG2P(checkpoint_dir=tmp_path)",
            'g2p = MultilingualG2P(checkpoint_dir=tmp_path, device="cpu")')),
    fixtures=True)


# the Mandarin suite's fixtures (`g2p`, `toy_hmm`), on the port
globals().update(jax_fixtures("test_mandarin_g2p.py", ("tts",), edits=G2PW_EDITS))


@pytest.fixture(scope="class")
def mg2p():
    """`TestMultilingualG2P.mg2p`: seeded random G2P_BASE on the CPU."""
    return port_g2p.MultilingualG2P(device="cpu")


@pytest.mark.parametrize("case", MANDARIN_CASES + NUMBER_CASES + MODEL_CASES
                         + MULTILINGUAL_CASES)
def test_jax_g2p_case_on_the_port(case, request):
    case(request)


def test_cases_cover_the_jax_suites():
    assert len(MANDARIN_CASES) >= 85 and len(NUMBER_CASES) >= 33
    assert [c.id for c in MODEL_CASES] == ["test_encode_word"]
    assert len(MULTILINGUAL_CASES) == 4
