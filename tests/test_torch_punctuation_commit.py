"""`asr/punctuation_commit.py` of the PyTorch port (a host-only copy) against
JAX: every case of `tests/test_punctuation_commit.py` runs against the
port's `PunctuationCommitLayer` (`jax_cases`), and a seeded sequence of
partials, EOUs, debounce polls and resets gives the same committed and
ghost text from both."""

import numpy as np
import pytest

from fluidaudio_tpu.asr.punctuation_commit import PunctuationCommitLayer as JaxLayer
from fluidaudio_tpu_torch.asr.punctuation_commit import PunctuationCommitLayer as PortLayer
from tests.test_torch_custom_vocab import jax_cases, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", jax_cases("test_punctuation_commit.py"))
def test_jax_punctuation_commit_case_on_the_port(case):
    case()


def test_seeded_session_equals_jax():
    """Seeded partials, EOUs, debounce polls, manual commits and resets on a
    fake clock: every update the same from both (the update's dataclass
    compares by its fields)."""

    def run(layer_cls):
        rs = np.random.RandomState(11)
        now = [0.0]
        layer = layer_cls(clock=lambda: now[0])
        words = ["hello", "world.", "how", "are", "you?", "fine", "thanks!", "ok"]
        text, seen = "", []
        for _ in range(200):
            op = rs.randint(0, 10)
            now[0] += float(rs.uniform(0.5, 5.0))
            if op < 6:
                text = (text + " " + words[rs.randint(len(words))]).strip()
                update = layer.process_partial_text(text)
                if update.last_commit_reason:  # committed: the next partial starts over
                    text = update.ghost_text
            elif op == 6:
                update, text = layer.process_eou(), ""
            elif op == 7:
                update = layer.check_debounce()
            elif op == 8:
                update, text = layer.manual_commit(), ""
            else:
                update, text = layer.reset(), ""
            seen.append(None if update is None else vars(update))
        return seen

    got = run(PortLayer)
    assert got == run(JaxLayer)
    assert any(u and u["last_commit_reason"] == "debounce" for u in got)
