"""RTTM and AMI annotation parsing of the PyTorch port (`metrics/{rttm,ami,
ami_corpus}.py`) against JAX.

The three modules are host copies of the JAX package's (they import no JAX).
Every case of `tests/test_ami_corpus.py` (NXT XML parsing, the word-aligned,
official and frame-quantised DER references, Kaldi splits, RTTM staging) and
of `tests/test_ami_parser.py` (Kaldi segments and text) runs here on the
port's modules (`jax_cases`). Then the port's RTTM reader and writer and the
AMI references are held against the JAX functions on the same inputs.
"""

import pytest

from fluidaudio_tpu.metrics import ami_corpus as jax_ac
from fluidaudio_tpu.metrics import rttm as jax_rttm
from fluidaudio_tpu_torch.metrics import ami_corpus as port_ac
from fluidaudio_tpu_torch.metrics import rttm as port_rttm
from tests.test_torch_custom_vocab import jax_cases, jax_module, one_torch_thread  # noqa: F401

AMI_CORPUS_CASES = jax_cases("test_ami_corpus.py", fixtures=True)
AMI_PARSER_CASES = jax_cases("test_ami_parser.py")


def test_every_jax_case_is_collected():
    assert len(AMI_CORPUS_CASES) == 18 and len(AMI_PARSER_CASES) == 4


@pytest.mark.parametrize("case", AMI_CORPUS_CASES)
def test_jax_ami_corpus_case_on_the_port(case, request):
    case(request)


@pytest.mark.parametrize("case", AMI_PARSER_CASES)
def test_jax_ami_parser_case_on_the_port(case):
    case()


RTTM = ("SPEAKER m 1 2.00 2.50 <NA> <NA> B <NA> <NA>\n"
        "junk line\n"
        "SPEAKER m 1 0.00 2.00 <NA> <NA> A <NA> <NA>\n"
        "SPEAKER m 1 4.25 0.75 <NA> <NA> A <NA> <NA>\n")


def _segments(segs):
    return [(s.speaker_id, s.start_time, s.end_time) for s in segs]


def test_rttm_round_trip_equals_jax(tmp_path):
    path = tmp_path / "m.rttm"
    path.write_text(RTTM)
    for source in (RTTM, path, str(path)):
        got, want = port_rttm.parse_rttm(source), jax_rttm.parse_rttm(source)
        assert _segments(got) == _segments(want)
    written = port_rttm.write_rttm(port_rttm.parse_rttm(RTTM), "m")
    assert written == jax_rttm.write_rttm(jax_rttm.parse_rttm(RTTM), "m")
    assert port_rttm.write_rttm([]) == jax_rttm.write_rttm([]) == ""


WITH_SEGMENTS = ("load_word_aligned_der_reference", "load_frame_aligned_der_reference")


@pytest.mark.parametrize("loader", ["load_word_aligned_der_reference",
                                    "load_official_ground_truth",
                                    "load_frame_aligned_der_reference",
                                    "load_ami_ground_truth"])
def test_ami_references_equal_jax(tmp_path, loader):
    """The DER references of one NXT fixture (built by the JAX test's own
    `make_ami_fixture`) through both packages (its official segments are
    all shorter than the 0.5 s filter, so those two references are empty in
    both)."""
    root = jax_module("test_ami_corpus.py", modules=("metrics",)).make_ami_fixture(tmp_path)
    got = getattr(port_ac, loader)("ES2004a", root)
    want = getattr(jax_ac, loader)("ES2004a", root)
    assert _segments(got) == _segments(want)
    assert bool(got) == (loader in WITH_SEGMENTS)
