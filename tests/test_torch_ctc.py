"""CTC decoding of the PyTorch port (`ops/ctc_decode.py`) against JAX.

`ctc_greedy_decode` runs on the device in the port (a stable sort of an
int32 key left-packs the kept frames); on seeded random log-probs with
ragged lengths, forced repeats, blank runs, all-blank rows and a
zero-length row it gives JAX's tokens, frames and counts exactly, padding
included. The host-side prefix beam search and ARPA reader are copies:
they equal JAX's on seeded log-probs, with and without the language model,
and the keyword-DP and greedy/beam cases of `tests/test_ctc_scenarios.py`
that take no fixture run against the port (`jax_cases`).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.ops import ctc_decode as jax_ctc
from fluidaudio_tpu_torch.ops import ctc_decode as port_ctc
from tests.test_ctc_scenarios import ARPA_TEXT
from tests.test_torch_custom_vocab import jax_cases, one_torch_thread  # noqa: F401


def _log_probs(seed, B, T, V, blank):
    """Peaked random log-probs with repeats, blank runs and an all-blank row."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(B, T, V).astype(np.float32)
    best = rs.randint(0, V, size=(B, T))
    best[:, 1::3] = best[:, 0::3][:, : best[:, 1::3].shape[1]]  # repeats
    best[:, 5:9] = blank  # a blank run
    best[-1] = blank  # an all-blank row
    np.put_along_axis(logits, best[..., None], 8.0, axis=-1)
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


@pytest.mark.parametrize("blank", [0, 16])
@pytest.mark.parametrize("seed,B,T,V", [(0, 4, 23, 17), (1, 3, 188, 17), (2, 5, 64, 1025)])
def test_greedy_decode_equals_jax(seed, B, T, V, blank):
    blank = min(blank, V - 1)
    lp = _log_probs(seed, B, T, V, blank)
    lengths = np.array([T, T // 2, 0, 1, 7][:B - 1] + [T], np.int32)
    want = jax_ctc.ctc_greedy_decode(jnp.asarray(lp), jnp.asarray(lengths), blank)
    got = port_ctc.ctc_greedy_decode(torch.from_numpy(lp), torch.from_numpy(lengths), blank)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].sum() > 0 and int(got[2][-1]) == 0


def test_greedy_decode_zero_length_and_argmax_ties():
    """Ties take the first maximal index in both; a zero-length row keeps
    nothing."""
    lp = np.zeros((2, 5, 4), np.float32)  # every frame a four-way tie
    lengths = np.array([5, 0], np.int32)
    want = jax_ctc.ctc_greedy_decode(jnp.asarray(lp), jnp.asarray(lengths), 3)
    got = port_ctc.ctc_greedy_decode(torch.from_numpy(lp), torch.from_numpy(lengths), 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture()
def arpa_path(tmp_path):
    path = tmp_path / "lm.arpa"
    path.write_text(ARPA_TEXT)
    return path


def test_arpa_reader_equals_jax(arpa_path):
    want = jax_ctc.ARPALanguageModel.load(arpa_path)
    got = port_ctc.ARPALanguageModel.load(arpa_path)
    assert got.ngrams == want.ngrams and got.order == want.order
    words = ["<s>", "hello", "world", "friend", "zebra"]
    for ctx in [(), ("hello",), ("world",), ("<s>", "hello"), ("zebra",)]:
        for w in words:
            assert got.score(ctx, w) == want.score(ctx, w)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("with_lm", [False, True])
def test_beam_search_equals_jax(arpa_path, seed, with_lm):
    vocab = {0: "▁hello", 1: "▁world", 2: "▁friend", 3: "s", 4: "▁<s>"}
    lp = _log_probs(seed, 2, 30, 6, blank=5)[0] * 0.3  # flatter: the beam matters
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))

    def run(mod):
        lm = mod.ARPALanguageModel.load(arpa_path) if with_lm else None
        return mod.ctc_beam_search(lp, 5, beam_width=6, vocabulary=vocab, lm=lm,
                                   lm_weight=1.5)

    got = run(port_ctc)
    assert got == run(jax_ctc) and got


CASES = jax_cases("test_ctc_scenarios.py", modules=("asr.custom_vocab",),
                  select=("TestKeywordDp", "TestBeam"))


@pytest.mark.parametrize("case", CASES)
def test_jax_ctc_case_on_the_port(case):
    case()


def test_lm_flips_the_trailing_word(arpa_path):
    """The JAX scenario's case on the port: acoustics prefer "friend", the
    hello-world bigram flips it."""
    lm = port_ctc.ARPALanguageModel.load(arpa_path)
    vocab = {1: "▁hello", 2: "▁friend", 3: "▁world"}
    lp = np.full((2, 4), -10.0, np.float32)
    lp[0, 1] = 0.0
    lp[1, 2], lp[1, 3] = math.log(0.55), math.log(0.45)
    assert port_ctc.ctc_beam_search(lp, 0, beam_width=8, vocabulary=vocab) == [1, 2]
    assert port_ctc.ctc_beam_search(lp, 0, beam_width=8, vocabulary=vocab, lm=lm,
                                    lm_weight=3.0) == [1, 3]
