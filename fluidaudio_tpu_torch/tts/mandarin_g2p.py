"""Mandarin G2P: segmentation + pinyin lookup + tone sandhi + erhua + numbers.

Behavioral parity: reference `KokoroAne/G2P/Mandarin/` (11 files, ~2.2k LoC):
jieba-HMM-style segmentation (here: greedy longest-match over the lexicon),
third-tone sandhi, 不/一 sandhi, erhua (儿化) merging, and Mandarin number
reading (两 vs 二, unit grouping). The seed lexicon covers common words; a
full dictionary loads from the registry cache (`mandarin_lexicon.json`:
word -> pinyin-with-tone-number sequence).

A copy of the JAX package's `tts/mandarin_g2p.py` (host code), with
`MandarinG2pw` over the port's `models/bert_g2pw.py` on a torch device.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

from fluidaudio_tpu_torch.tts.mandarin_numbers import mandarin_normalize_numbers


class PinyinDictError(ValueError):
    """Truncated/invalid binary pinyin dict (`MandarinPinyinDict.LoadError`)."""


# pypinyin diacritic vowel -> (bare ASCII, tone). ü collapses to `v`
# (pypinyin Style.TONE3), matching MandarinPinyinNormalizer.swift:38-57.
_DIACRITIC_TABLE: dict[str, tuple[str, int]] = {
    "ā": ("a", 1), "á": ("a", 2), "ǎ": ("a", 3), "à": ("a", 4),
    "ē": ("e", 1), "é": ("e", 2), "ě": ("e", 3), "è": ("e", 4),
    "ī": ("i", 1), "í": ("i", 2), "ǐ": ("i", 3), "ì": ("i", 4),
    "ō": ("o", 1), "ó": ("o", 2), "ǒ": ("o", 3), "ò": ("o", 4),
    "ū": ("u", 1), "ú": ("u", 2), "ǔ": ("u", 3), "ù": ("u", 4),
    "ǖ": ("v", 1), "ǘ": ("v", 2), "ǚ": ("v", 3), "ǜ": ("v", 4),
    "ü": ("v", 0),
    "ń": ("n", 2), "ň": ("n", 3), "ǹ": ("n", 4), "ḿ": ("m", 2),
}


def normalize_pinyin(pinyin: str) -> str:
    """Diacritic pinyin (`níhǎo` syllable, `lǜ`) -> `<base><digit>` form
    (`ni2`, `lv4`); unmarked syllables get the neutral tone 5
    (`MandarinPinyinNormalizer.normalize`)."""
    base = []
    tone = 5
    for ch in pinyin:
        mapped = _DIACRITIC_TABLE.get(ch)
        if mapped is not None:
            base.append(mapped[0])
            if mapped[1] != 0:
                tone = mapped[1]
        else:
            base.append(ch)
    return "".join(base) + str(tone)


def parse_pinyin_singles(data: bytes) -> dict[int, list[str]]:
    """Parse `pinyin_single.bin` (`MandarinPinyinDict.parseSingles`):
    repeating [u32le codepoint, u8 count, count x (u8 len, utf8 pinyin)].
    Pinyins keep their diacritic form; callers normalize."""
    result: dict[int, list[str]] = {}
    pos = 0
    n = len(data)
    while pos < n:
        if pos + 5 > n:
            raise PinyinDictError("Mandarin G2P dict singles is truncated")
        cp = int.from_bytes(data[pos : pos + 4], "little")
        count = data[pos + 4]
        pos += 5
        readings: list[str] = []
        for _ in range(count):
            if pos >= n:
                raise PinyinDictError("Mandarin G2P dict singles pinyin is truncated")
            length = data[pos]
            pos += 1
            if pos + length > n:
                raise PinyinDictError(
                    "Mandarin G2P dict singles pinyin payload is truncated"
                )
            readings.append(data[pos : pos + length].decode("utf-8"))
            pos += length
        result[cp] = readings
    return result


def parse_pinyin_phrases(data: bytes) -> dict[str, list[str]]:
    """Parse `pinyin_phrases.bin` (`MandarinPinyinDict.parsePhrases`):
    repeating [u16le phrase_len, utf8 phrase, u8 count, count x (u8 len,
    utf8 pinyin)]."""
    result: dict[str, list[str]] = {}
    pos = 0
    n = len(data)
    while pos < n:
        if pos + 3 > n:
            raise PinyinDictError("Mandarin G2P dict phrases is truncated")
        phrase_len = int.from_bytes(data[pos : pos + 2], "little")
        pos += 2
        if pos + phrase_len + 1 > n:
            raise PinyinDictError("Mandarin G2P dict phrases payload is truncated")
        phrase = data[pos : pos + phrase_len].decode("utf-8")
        pos += phrase_len
        count = data[pos]
        pos += 1
        readings: list[str] = []
        for _ in range(count):
            if pos >= n:
                raise PinyinDictError("Mandarin G2P dict phrases pinyin is truncated")
            length = data[pos]
            pos += 1
            if pos + length > n:
                raise PinyinDictError(
                    "Mandarin G2P dict phrases pinyin payload is truncated"
                )
            readings.append(data[pos : pos + length].decode("utf-8"))
            pos += length
        result[phrase] = readings
    return result


def load_pinyin_dict_dir(base: str | Path) -> dict[str, str]:
    """Load the release binary dict layout (`pinyin_single.bin` +
    `pinyin_phrases.bin`, KokoroAneConstants.swift:55-59) into the
    word -> "pinyin2 tone3"-digit-form lexicon this module consumes.
    Singles keep their canonical (index-0) pypinyin reading; polyphone
    alternatives are g2pW's job."""
    base = Path(base)
    out: dict[str, str] = {}
    singles_f = base / "pinyin_single.bin"
    phrases_f = base / "pinyin_phrases.bin"
    if singles_f.exists():
        for cp, readings in parse_pinyin_singles(singles_f.read_bytes()).items():
            if readings:
                out[chr(cp)] = normalize_pinyin(readings[0])
    if phrases_f.exists():
        for phrase, readings in parse_pinyin_phrases(phrases_f.read_bytes()).items():
            if readings:
                out[phrase] = " ".join(normalize_pinyin(r) for r in readings)
    return out


# bopomofo tone diacritics -> digit (tone 1 carries no mark)
_BOPOMOFO_TONE_DIGITS = {"ˊ": "2", "ˇ": "3", "ˋ": "4", "˙": "5"}


def bopomofo_label_to_digit_form(label: str) -> str:
    """`ㄒㄧㄥˊ` -> `ㄒㄧㄥ2`; an unmarked label implies tone 1
    (`MandarinPolyphoneCatalog.bopomofoWithToneDigit`)."""
    if label and label[-1] in _BOPOMOFO_TONE_DIGITS:
        return label[:-1] + _BOPOMOFO_TONE_DIGITS[label[-1]]
    return label + "1"


@dataclass(frozen=True)
class MandarinPolyphoneCatalog:
    """`POLYPHONIC_CHARS.txt` inventory (`MandarinPolyphoneCatalog.swift`):
    one `<hanzi><TAB-or-space><bopomofo_with_tone>` row per valid
    pronunciation. The g2pW model's output dim equals `len(labels)`; only
    `candidates_by_char[ch]` indices are valid for a target char."""

    chars: list[str]  # first-appearance order (model target vocab)
    labels: list[str]  # sorted unique bopomofo labels
    candidates_by_char: dict[str, list[int]]

    @property
    def char_index(self) -> dict[str, int]:
        return {c: i for i, c in enumerate(self.chars)}

    def candidates(self, char: str) -> list[int] | None:
        return self.candidates_by_char.get(char)

    def bopomofo(self, label_idx: int) -> str | None:
        if 0 <= label_idx < len(self.labels):
            return self.labels[label_idx]
        return None

    def bopomofo_with_tone_digit(self, label_idx: int) -> str | None:
        label = self.bopomofo(label_idx)
        return bopomofo_label_to_digit_form(label) if label is not None else None


def parse_polyphone_catalog(text: str) -> MandarinPolyphoneCatalog:
    """Parse POLYPHONIC_CHARS.txt; blank/#-comment lines skipped, CRLF
    tolerated, malformed rows and multi-hanzi keys rejected."""
    seen_chars: list[str] = []
    seen_set: set[str] = set()
    label_set: set[str] = set()
    raw_cands: dict[str, list[str]] = {}
    for raw_line in text.replace("\r\n", "\n").replace("\r", "\n").split("\n"):
        line = raw_line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.replace("\t", " ").split(None, 1)
        if len(parts) != 2:
            raise PinyinDictError(
                f"POLYPHONIC_CHARS parse error: expected '<hanzi><sep><bopomofo>', got {line!r}"
            )
        ch, label = parts[0], parts[1].strip()
        if len(ch) != 1:
            raise PinyinDictError(
                f"POLYPHONIC_CHARS parse error: expected single hanzi in column 1, got {ch!r}"
            )
        if not label:
            raise PinyinDictError(
                f"POLYPHONIC_CHARS parse error: empty bopomofo for {ch!r}"
            )
        if ch not in seen_set:
            seen_chars.append(ch)
            seen_set.add(ch)
        label_set.add(label)
        raw_cands.setdefault(ch, []).append(label)

    labels = sorted(label_set)
    label_to_idx = {lb: i for i, lb in enumerate(labels)}
    cands: dict[str, list[int]] = {}
    for ch, lst in raw_cands.items():
        seen_idx: set[int] = set()
        indices: list[int] = []
        for lb in lst:
            idx = label_to_idx[lb]
            if idx not in seen_idx:
                seen_idx.add(idx)
                indices.append(idx)
        cands[ch] = indices
    return MandarinPolyphoneCatalog(
        chars=seen_chars, labels=labels, candidates_by_char=cands
    )


# fullwidth CJK punctuation -> halfwidth (MandarinG2P.normalizeText)
_FULLWIDTH_PUNCT = str.maketrans({
    "，": ",", "。": ".", "！": "!", "？": "?", "；": ";", "：": ":",
    "、": ",", "（": "(", "）": ")", "【": "[", "】": "]",
    "“": '"', "”": '"', "‘": "'", "’": "'", "…": "...",
})

# word -> space-separated pinyin with tone numbers (seed; full dict from assets)
_SEED_LEXICON: dict[str, str] = {
    "你好": "ni3 hao3", "你": "ni3", "好": "hao3", "我": "wo3", "他": "ta1",
    "她": "ta1", "们": "men5", "我们": "wo3 men5", "是": "shi4", "不": "bu4",
    "不是": "bu4 shi4", "一": "yi1", "二": "er4", "三": "san1", "四": "si4",
    "五": "wu3", "六": "liu4", "七": "qi1", "八": "ba1", "九": "jiu3",
    "十": "shi2", "百": "bai3", "千": "qian1", "万": "wan4", "亿": "yi4",
    "零": "ling2", "两": "liang3", "个": "ge4", "人": "ren2", "中国": "zhong1 guo2",
    "中": "zhong1", "国": "guo2", "说": "shuo1", "话": "hua4", "说话": "shuo1 hua4",
    "很": "hen3", "很好": "hen3 hao3", "谢谢": "xie4 xie5", "再见": "zai4 jian4",
    "天": "tian1", "今天": "jin1 tian1", "明天": "ming2 tian1", "点": "dian3",
    "儿": "er5", "花": "hua1", "花儿": "hua1 er5", "玩": "wan2", "玩儿": "wan2 er5",
    "想": "xiang3", "要": "yao4", "去": "qu4", "来": "lai2", "吃": "chi1",
    "饭": "fan4", "吃饭": "chi1 fan4", "水": "shui3", "喝": "he1",
}

_DIGITS = "零一二三四五六七八九"
_UNITS = ["", "十", "百", "千"]
_GROUPS = ["", "万", "亿"]


def number_to_mandarin(n: int) -> str:
    """Integer -> Mandarin reading (两 for leading 2 before units, 零 rules)."""
    if n == 0:
        return "零"
    if n < 0:
        return "负" + number_to_mandarin(-n)
    groups = []
    while n > 0:
        groups.append(n % 10_000)
        n //= 10_000
    parts: list[str] = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            continue
        text = _group_to_mandarin(g, full=gi < len(groups) - 1)
        parts.append(text + _GROUPS[gi])
        # 零 between non-adjacent groups
        if gi > 0 and groups[gi - 1] != 0 and groups[gi - 1] < 1000:
            parts.append("零")
    out = "".join(parts)
    # 一十X -> 十X at the very front
    if out.startswith("一十"):
        out = out[1:]
    return out.rstrip("零") or "零"


def _group_to_mandarin(g: int, full: bool) -> str:
    digits = [int(d) for d in str(g)]
    out = []
    zero_pending = False
    for i, d in enumerate(digits):
        unit = _UNITS[len(digits) - 1 - i]
        if d == 0:
            zero_pending = bool(out)
            continue
        if zero_pending:
            out.append("零")
            zero_pending = False
        reading = "两" if (d == 2 and unit in ("百", "千")) else _DIGITS[d]
        out.append(reading + unit)
    return "".join(out)


class MandarinG2P:
    def __init__(self, lexicon_path: str | Path | None = None, *, g2pw=None,
                 jieba_hmm: "MandarinJiebaHmm | None" = None,
                 pos_lookup=None):
        self.lexicon = dict(_SEED_LEXICON)
        if lexicon_path:
            p = Path(lexicon_path)
            if p.is_dir():
                # release layout: binary pinyin_single.bin/pinyin_phrases.bin
                self.lexicon.update(load_pinyin_dict_dir(p))
            elif p.exists():
                self.lexicon.update(json.loads(p.read_text()))
        self._max_word = max(len(w) for w in self.lexicon)
        # optional sentence-context polyphone disambiguator (MandarinG2pw);
        # None = pinyin-dict path only (reference g2pw == nil contract)
        self.g2pw = g2pw
        # optional jieba BMES HMM: re-segments runs of chars the
        # longest-match loop missed (OOV proper nouns like 特朗普);
        # None = per-char fallback (reference jiebaHmm == nil contract)
        self.jieba_hmm = jieba_hmm
        # user pronunciation overrides, matched longest-prefix BEFORE the
        # bundled lexicon (reference MandarinCustomLexicon.swift:17-43):
        # word -> list of tokens, each either pinyin-with-tone ("zi4",
        # joins the sandhi window) or "@"-escaped bopomofo ("@ㄈㄨ4",
        # emitted verbatim, bypasses sandhi)
        self.custom_lexicon: dict[str, list[str]] = {}
        self._max_custom = 0
        # optional POS tagger `word -> jieba tag`; when set, phonemize()
        # routes through the POS-aware sandhi (MandarinToneSandhiPOS.swift
        # contract: callers without a tagger keep the baseline rules)
        self.pos_lookup = pos_lookup

    @staticmethod
    def normalize_text(text: str) -> str:
        """Fullwidth CJK punctuation -> halfwidth (`MandarinG2P.normalizeText`):
        你好，世界。 -> 你好,世界."""
        return text.translate(_FULLWIDTH_PUNCT)

    @staticmethod
    def looks_like_hanzi(text: str) -> bool:
        """True when the string contains any CJK unified ideograph —
        the reference's routing gate between the Hanzi G2P pipeline and
        phoneme passthrough (`KokoroAneManager.swift:244-252`)."""
        return any(
            "一" <= c <= "鿿" or "㐀" <= c <= "䶿" for c in text
        )

    def set_custom_lexicon(self, entries: dict[str, list[str]]) -> None:
        """Install (or clear with {}) user pronunciation overrides.

        Validates every token up front like the reference
        (`MandarinCustomLexicon.swift:65-210`): pinyin tokens must encode
        through the bopomofo map; `@`-tokens must contain only characters
        the zh vocab can emit (bopomofo glyphs, special hanzi finals,
        tone digits, allowed punctuation)."""
        validated: dict[str, list[str]] = {}
        for word, tokens in entries.items():
            if not word or not tokens:
                raise ValueError(f"custom lexicon entry {word!r} is empty")
            for tok in tokens:
                if tok.startswith("@"):
                    bad = [
                        c for c in tok[1:]
                        if c not in _BOPOMOFO_EMIT_CHARS
                    ]
                    if bad or len(tok) == 1:
                        raise ValueError(
                            f"{word!r}: bopomofo token {tok!r} has characters "
                            f"outside the zh vocab: {bad}")
                else:
                    base, tone = _split_tone(tok)
                    if encode_bopomofo(base, tone) is None:
                        raise ValueError(
                            f"{word!r}: pinyin token {tok!r} does not encode")
            validated[word] = list(tokens)
        self.custom_lexicon = validated
        self._max_custom = max((len(w) for w in validated), default=0)

    @staticmethod
    def parse_custom_lexicon(content: str) -> dict[str, list[str]]:
        """Parse the user lexicon text format
        (`MandarinCustomLexicon.parse`, MandarinCustomLexicon.swift:143-182):

            # comments and blank lines are skipped
            字节跳动  zi4 jie2 tiao4 dong4
            foo       @ㄈㄨ4

        The first whitespace run separates the word from its tokens.
        Raises on token-less lines and duplicate words (last-wins is too
        easy to misread; callers dedupe explicitly). Token validation
        happens in `set_custom_lexicon`.
        """
        raw: dict[str, list[str]] = {}
        for idx, raw_line in enumerate(content.split("\n")):
            line = raw_line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 2:
                raise ValueError(
                    f"custom lexicon: line {idx + 1} has no tokens: {line!r}"
                )
            word = parts[0]
            if word in raw:
                raise ValueError(
                    f"custom lexicon: duplicate word {word!r} on line {idx + 1}"
                )
            raw[word] = parts[1:]
        return raw

    def load_custom_lexicon(self, path: str | Path) -> None:
        """Load + validate a lexicon file (`MandarinCustomLexicon.load`)."""
        self.set_custom_lexicon(
            self.parse_custom_lexicon(Path(path).read_text(encoding="utf-8"))
        )

    # -------------------------------------------------------------- segmenter

    def _flush_run(self, run: str) -> list[str]:
        """Re-segment a run of FMM-missed single chars: jieba-HMM words are
        retried against the phrase dict, then fall back per-char (reference
        `MandarinG2P.swift:262-302` flushHanziRun)."""
        if not run:
            return []
        words = self.jieba_hmm.segment(run) if self.jieba_hmm else list(run)
        out: list[str] = []
        for w in words:
            if len(w) >= 2 and w in self.lexicon:
                out.append(w)
            else:
                out.extend(w)  # per-char fallback (polyphones flagged there)
        return out

    def segment(self, text: str) -> list[str]:
        """Greedy longest-match segmentation over the lexicon (jieba-dict
        role), with an HMM post-pass over runs the FMM missed."""
        out: list[str] = []
        run = ""
        i = 0
        while i < len(text):
            for ln in range(min(self._max_word, len(text) - i), 1, -1):
                cand = text[i : i + ln]
                if cand in self.lexicon:
                    out.extend(self._flush_run(run))
                    run = ""
                    out.append(cand)
                    i += ln
                    break
            else:
                run += text[i]
                i += 1
        out.extend(self._flush_run(run))
        return out

    # ---------------------------------------------------------------- pinyin

    def word_to_pinyin(self, word: str) -> list[str]:
        if word in self.lexicon:
            return self.lexicon[word].split()
        out: list[str] = []
        for ch in word:
            if ch in self.lexicon:
                out.extend(self.lexicon[ch].split())
            elif ch.isdigit():
                num = number_to_mandarin(int(ch))
                out.extend(self.word_to_pinyin(num))
            # unknown hanzi dropped (full dict resolves them)
        return out

    # ------------------------------------------------------------ tone sandhi

    @staticmethod
    def apply_tone_sandhi(syllables: list[str]) -> list[str]:
        """Third-tone chains (3+3 -> 2+3), 不 (bu4 -> bu2 before tone 4),
        一 (yi1 -> yi4 before 1/2/3, yi2 before 4)."""
        out = list(syllables)

        def tone(s: str) -> int:
            return int(s[-1]) if s and s[-1].isdigit() else 5

        def retone(s: str, t: int) -> str:
            return (s[:-1] if s[-1].isdigit() else s) + str(t)

        # third-tone sandhi against the ORIGINAL tones so chains resolve
        # as 3 3 3 -> 2 2 3 (我很好 -> wo2 hen2 hao3)
        orig_tones = [tone(s) for s in out]
        for i in range(len(out) - 1):
            if orig_tones[i] == 3 and orig_tones[i + 1] == 3:
                out[i] = retone(out[i], 2)
        # 不 sandhi
        for i, s in enumerate(out[:-1]):
            if s.startswith("bu") and tone(s) == 4 and tone(out[i + 1]) == 4:
                out[i] = retone(s, 2)
        # 一 sandhi
        for i, s in enumerate(out[:-1]):
            if s in ("yi1",):
                nxt = tone(out[i + 1])
                out[i] = "yi2" if nxt == 4 else ("yi4" if nxt in (1, 2, 3) else s)
        return out

    @staticmethod
    def apply_tone_sandhi_pos(
        syllables: list[str],
        words: list[tuple[int, int]],
        tags: list[str],
    ) -> list[str]:
        """POS-aware tone sandhi (reference `MandarinToneSandhiPOS.swift`).

        Replaces `apply_tone_sandhi` for callers with a POS tagger. Adds the
        carve-outs the baseline deliberately misses:
        - ordinal 一 (solo one-syllable word tagged `m`) keeps tone 1
        - 不 reduplication ([X, 不, X]) keeps tone 4
        - 3+3 is scoped per prosodic word, with a one-step cross-word
          boundary promotion (no cascading runs across words)

        `words` partitions the syllable indices as (start, end) half-open
        ranges; `tags` is the per-word jieba POS tag. Both must align.
        """
        if len(words) != len(tags):
            raise ValueError(
                f"words ({len(words)}) and tags ({len(tags)}) must align"
            )
        out = list(syllables)
        if len(out) < 2:
            return out

        def tone(s: str) -> int:
            return int(s[-1]) if s and s[-1].isdigit() else 5

        def base(s: str) -> str:
            return s[:-1] if s and s[-1].isdigit() else s

        def retone(s: str, t: int) -> str:
            return base(s) + str(t)

        word_of = [-1] * len(out)
        for w_idx, (lo, hi) in enumerate(words):
            for s_idx in range(lo, hi):
                if 0 <= s_idx < len(out):
                    word_of[s_idx] = w_idx

        # Pass 1: 不 / 一 contextual sandhi with POS carve-outs.
        for i in range(len(out) - 1):
            cur, nxt = out[i], out[i + 1]
            if base(cur) == "bu" and tone(cur) == 4 and tone(nxt) == 4:
                # 好不好/要不要: [X, 不, X] keeps tone 4
                redup = i >= 1 and base(out[i - 1]) == base(nxt)
                if not redup:
                    out[i] = retone(cur, 2)
            elif base(cur) == "yi" and tone(cur) == 1:
                w_idx = word_of[i]
                if 0 <= w_idx < len(tags):
                    lo, hi = words[w_idx]
                    if hi - lo == 1 and tags[w_idx] == "m":
                        continue  # ordinal 第一/一月: keep tone 1
                nt = tone(nxt)
                if nt == 4:
                    out[i] = retone(cur, 2)
                elif nt in (1, 2, 3):
                    out[i] = retone(cur, 4)

        # Pass 2a: in-word 3+3 runs promote every syllable but the last.
        for lo, hi in words:
            i = lo
            while i < hi:
                if tone(out[i]) != 3:
                    i += 1
                    continue
                j = i
                while j < hi and tone(out[j]) == 3:
                    j += 1
                if j - i >= 2:
                    for k in range(i, j - 1):
                        out[k] = retone(out[k], 2)
                i = j

        # Pass 2b: cross-word boundary (3, 3) promotes only the word-final
        # syllable of the left word; no further cascading.
        for k in range(len(words) - 1):
            llo, lhi = words[k]
            rlo, rhi = words[k + 1]
            if lhi <= llo or rhi <= rlo:
                continue
            if tone(out[lhi - 1]) == 3 and tone(out[rlo]) == 3:
                out[lhi - 1] = retone(out[lhi - 1], 2)

        return out

    # ---------------------------------------------------------------- erhua

    @staticmethod
    def apply_erhua(syllables: list[str]) -> list[str]:
        """Merge neutral-tone 儿 (er5) into the preceding syllable: huar.

        Leading er is kept (儿子), and a back-to-back er+er5 is left alone —
        no second-pass merge into a preceding er (ref
        `MandarinErhua.swift`, `MandarinErhuaTests.swift:57-102`)."""
        out: list[str] = []
        for s in syllables:
            if s == "er5" and out:
                prev = out[-1]
                tone_ch = prev[-1] if prev[-1].isdigit() else ""
                core = prev[:-1] if tone_ch else prev
                if core.endswith("r"):
                    # prev is an er or already r-coloured: do not merge
                    out.append(s)
                    continue
                out[-1] = core + "r" + tone_ch
            else:
                out.append(s)
        return out

    # ----------------------------------------------------------------- public

    def phonemize(self, text: str) -> str:
        """zh text -> tone-numbered pinyin string (sandhi + erhua applied).

        With a wired g2pW model, single-character polyphonic segments are
        disambiguated from sentence context before sandhi (reference
        `MandarinG2P.swift:97-114`: dict path with per-target g2pW
        overrides; phrase matches keep their lexicon reading)."""
        # fullwidth punctuation + numbers first
        text = mandarin_normalize_numbers(self.normalize_text(text))
        segments = self.segment(text)
        overrides: dict[int, str] = {}
        if self.g2pw is not None:
            pos = 0
            targets = []
            for seg in segments:
                if len(seg) == 1 and seg in self.g2pw.catalog:
                    targets.append(pos)
                pos += len(seg)
            overrides = self.g2pw.disambiguate(text, targets)
        syllables: list[str] = []
        word_ranges: list[tuple[int, int]] = []
        word_tags: list[str] = []
        pos = 0
        for word in segments:
            start = len(syllables)
            if pos in overrides and len(word) == 1:
                syllables.append(overrides[pos])
            else:
                syllables.extend(self.word_to_pinyin(word))
            if self.pos_lookup is not None and len(syllables) > start:
                word_ranges.append((start, len(syllables)))
                word_tags.append(self.pos_lookup(word) or "x")
            pos += len(word)
        if self.pos_lookup is not None:
            syllables = self.apply_tone_sandhi_pos(syllables, word_ranges, word_tags)
        else:
            syllables = self.apply_tone_sandhi(syllables)
        syllables = self.apply_erhua(syllables)
        return " ".join(syllables)

    def phonemize_bopomofo(self, text: str) -> str:
        """zh text -> the bopomofo + tone-digit stream the kokoro ANE-zh
        vocab expects, syllables concatenated with no separator
        (reference `MandarinG2P.swift:87-180`).

        Pipeline: number verbalization -> typed segmentation (custom
        lexicon longest-prefix first, then bundled dict, then punctuation
        / ASCII-literal passthrough) -> per-window erhua merge THEN tone
        sandhi (so 3+3 promotion sees the r-coloured syllable as one
        tonal unit) -> bopomofo encode. Sandhi windows break at
        punctuation, literals, `@`-bopomofo tokens, and g2pW picks."""
        text = mandarin_normalize_numbers(self.normalize_text(text))
        segments = self._segment_typed(text)

        # g2pW polyphone picks: single-char dict segments in the catalog
        overrides: dict[int, str] = {}
        if self.g2pw is not None:
            targets = [
                pos for kind, val, pos in segments
                if kind == "char" and val in self.g2pw.catalog
            ]
            if targets:
                overrides = self.g2pw.disambiguate(text, targets)

        out: list[str] = []
        window: list[str] = []  # pending pinyin syllables (sandhi scope)

        def flush() -> None:
            if not window:
                return
            merged = self.apply_erhua(window)
            merged = self.apply_tone_sandhi(merged)
            for s in merged:
                bo = _encode_pinyin_syllable(s)
                if bo is not None:
                    out.append(bo)
            window.clear()

        for kind, val, pos in segments:
            if kind == "custom":
                for tok in val:
                    if tok.startswith("@"):
                        flush()
                        out.append(tok[1:])
                    else:
                        window.append(tok)
            elif kind == "char" and pos in overrides:
                # g2pW pick: encode directly and break the sandhi window
                # (reference .bopomofoOverride contract). POLYPHONIC_CHARS
                # catalogs yield final-form bopomofo labels that pass
                # through verbatim; pinyin labels encode first.
                flush()
                pick = overrides[pos]
                bo = _encode_pinyin_syllable(pick)
                out.append(bo if bo is not None else pick)
            elif kind in ("word", "char"):
                window.extend(self.word_to_pinyin(val))
            elif kind == "punct":
                flush()
                out.append(val)
            else:  # literal ASCII letters; vocab encodes what it can
                flush()
                out.append(val)
        flush()
        return "".join(out)

    def _segment_typed(self, text: str) -> list[tuple[str, object, int]]:
        """-> [(kind, value, char_pos)]: kind in {custom, word, char,
        punct, literal}. Custom-lexicon entries win over equal-length
        dict entries (reference MandarinCustomLexicon front-of-cascade)."""
        segs: list[tuple[str, object, int]] = []
        run: list[tuple[str, int]] = []  # buffered FMM-missed hanzi chars

        def flush_run() -> None:
            # HMM re-segmentation of the buffered run; dict hits become
            # word segments, the rest per-char at their original positions
            # (reference `MandarinG2P.swift:262-302`)
            if not run:
                return
            chars = "".join(c for c, _ in run)
            pos0 = 0
            for w in (self.jieba_hmm.segment(chars) if self.jieba_hmm
                      else list(chars)):
                if len(w) >= 2 and w in self.lexicon:
                    segs.append(("word", w, run[pos0][1]))
                else:
                    for k, ch in enumerate(w):
                        segs.append(("char", ch, run[pos0 + k][1]))
                pos0 += len(w)
            run.clear()

        i = 0
        n = len(text)
        while i < n:
            matched = False
            for ln in range(min(self._max_custom, n - i), 0, -1):
                cand = text[i : i + ln]
                if cand in self.custom_lexicon:
                    # only take a shorter-than-dict custom match if no
                    # longer dict word starts here (user wins ties only)
                    dict_ln = self._longest_dict_match(text, i)
                    if dict_ln <= ln:
                        flush_run()
                        segs.append(("custom", self.custom_lexicon[cand], i))
                        i += ln
                        matched = True
                    break
            if matched:
                continue
            ln = self._longest_dict_match(text, i)
            if ln > 1:
                flush_run()
                segs.append(("word", text[i : i + ln], i))
                i += ln
                continue
            ch = text[i]
            if ch in self.lexicon or self.looks_like_hanzi(ch):
                run.append((ch, i))  # single/OOV hanzi: HMM post-pass
            elif ch in ALLOWED_PUNCTUATION:
                flush_run()
                segs.append(("punct", ch, i))
            elif ch.isascii() and (ch.isalnum()):
                flush_run()
                segs.append(("literal", ch, i))
            else:
                flush_run()  # unmapped unicode drops, but breaks the run
            i += 1
        flush_run()
        return segs

    def _longest_dict_match(self, text: str, i: int) -> int:
        for ln in range(min(self._max_word, len(text) - i), 1, -1):
            if text[i : i + ln] in self.lexicon:
                return ln
        return 1


# ---------------------------------------------------------------------------
# jieba BMES HMM (reference MandarinJiebaHmm.swift — OOV word recovery)
# ---------------------------------------------------------------------------

# state order matches jieba.finalseg: B(egin) M(iddle) E(nd) S(ingle)
_HMM_B, _HMM_M, _HMM_E, _HMM_S = 0, 1, 2, 3
# valid predecessors per next state (jieba PrevStatus): a word must end
# before another starts; M/E must be inside a started word
_HMM_PREV = {
    _HMM_B: (_HMM_E, _HMM_S),
    _HMM_M: (_HMM_M, _HMM_B),
    _HMM_E: (_HMM_B, _HMM_M),
    _HMM_S: (_HMM_S, _HMM_E),
}
HMM_UNKNOWN_LOG_PROB = -3.14e38  # reference MandarinJiebaHmmTables:45


@dataclass
class JiebaHmmTables:
    """start [4], trans [4][4], emit {char: [4]} log-probabilities."""

    start: list[float]
    trans: list[list[float]]
    emit: dict[str, list[float]]

    def __post_init__(self):
        if len(self.start) != 4:
            raise ValueError(f"start must have 4 states, got {len(self.start)}")
        if len(self.trans) != 4 or any(len(r) != 4 for r in self.trans):
            raise ValueError("trans must be 4x4")
        for ch, row in self.emit.items():
            if len(row) != 4:
                raise ValueError(f"emit[{ch!r}] must have 4 states, got {len(row)}")


class MandarinJiebaHmm:
    """Jieba's character-position HMM as a standalone BMES Viterbi decoder
    (reference `MandarinJiebaHmm.swift:19-168`).

    Post-pass over runs of consecutive single-character lookups the
    forward-maximum-match phrase loop missed (OOV proper nouns like
    特朗普/比特币): scores argmax_path P(states | chars) and reads off
    contiguous B..E / S spans as words. Deterministic and stateless."""

    def __init__(self, tables: JiebaHmmTables):
        self.tables = tables

    @classmethod
    def load(cls, path: str | Path) -> "MandarinJiebaHmm | None":
        """Load tables from a JSON asset ({start, trans, emit}); None when
        the asset is missing/unparsable (callers degrade to per-char)."""
        p = Path(path)
        if not p.exists():
            return None
        try:
            raw = json.loads(p.read_text())
            return cls(JiebaHmmTables(
                start=list(raw["start"]),
                trans=[list(r) for r in raw["trans"]],
                emit={k: list(v) for k, v in raw["emit"].items()},
            ))
        except (ValueError, KeyError, TypeError):
            return None

    def _emission(self, ch: str) -> list[float]:
        row = self.tables.emit.get(ch)
        return row if row is not None else [HMM_UNKNOWN_LOG_PROB] * 4

    def segment(self, text: str) -> list[str]:
        """Viterbi-decode `text` into words. Empty -> []; single char
        bypasses the decoder; output always concatenates back to input."""
        chars = list(text)
        if not chars:
            return []
        if len(chars) == 1:
            return [text]

        neg_inf = float("-inf")
        n = len(chars)
        emit0 = self._emission(chars[0])
        # t = 0: only B and S may start (M/E need an in-word predecessor)
        v_prev = [
            self.tables.start[s] + emit0[s] if s in (_HMM_B, _HMM_S) else neg_inf
            for s in range(4)
        ]
        back: list[list[int]] = []
        for t in range(1, n):
            emit = self._emission(chars[t])
            v_cur = [neg_inf] * 4
            b_cur = [0] * 4
            for to in range(4):
                best, best_from = neg_inf, _HMM_PREV[to][0]
                for frm in _HMM_PREV[to]:
                    cand = v_prev[frm] + self.tables.trans[frm][to] + emit[to]
                    if cand > best:
                        best, best_from = cand, frm
                v_cur[to] = best
                b_cur[to] = best_from
            v_prev = v_cur
            back.append(b_cur)

        # only E and S are valid sentence-final states
        cur = _HMM_E if v_prev[_HMM_E] >= v_prev[_HMM_S] else _HMM_S
        states = [0] * n
        states[-1] = cur
        for t in range(n - 2, -1, -1):
            cur = back[t][cur]
            states[t] = cur

        words: list[str] = []
        word_start = 0
        for i, s in enumerate(states):
            if s == _HMM_S:
                words.append(chars[i])
                word_start = i + 1
            elif s == _HMM_E:
                words.append("".join(chars[word_start : i + 1]))
                word_start = i + 1
        if word_start < n:  # tail flush: path ended mid-word
            words.append("".join(chars[word_start:]))
        return words


# ---------------------------------------------------------------------------
# g2pW polyphone disambiguation (optional, reference MandarinG2pwModel)
# ---------------------------------------------------------------------------


class MandarinG2pw:
    """Sentence-context polyphone disambiguator over the BERT classifier
    (`models/bert_g2pw.py`).

    Loads from a cached directory holding `g2pw.npz`, `config.json` (HF
    BERT), `vocab.txt` (BERT char vocab, one token per line), and
    `polyphone_catalog.json` ({char: {pinyin: label_index}}) — the same
    assets the reference ships under `kokoro-82m-coreml/ANE-zh/g2pw`
    (`MandarinG2pwModel.swift:31`). `load()` returns None when any piece is
    missing so callers degrade to the pinyin-dict path, exactly like the
    reference's `g2pw == nil` contract. The classifier runs on `device`
    (None = the GPU): one batched call per sentence, one copy back.
    """

    MAX_LENGTH = 128

    def __init__(self, model, char_to_id: dict[str, int],
                 catalog: dict[str, dict[str, int]]):
        self.model = model
        self.char_to_id = char_to_id
        self.catalog = catalog

    @property
    def device(self):
        return self.model.classifier.weight.device

    @classmethod
    def load(cls, checkpoint_dir: str | Path, device=None) -> "MandarinG2pw | None":
        base = Path(checkpoint_dir)
        needed = ["g2pw.npz", "config.json", "vocab.txt"]
        has_json = (base / "polyphone_catalog.json").exists()
        has_txt = (base / "POLYPHONIC_CHARS.txt").exists()
        if not (all((base / f).exists() for f in needed) and (has_json or has_txt)):
            return None
        from fluidaudio_tpu_torch.models.bert_g2pw import BertG2pw, config_from_hf
        from fluidaudio_tpu_torch.utils.device import resolve_device
        from fluidaudio_tpu_torch.utils.weights import load_npz, load_state

        cfg = config_from_hf(json.loads((base / "config.json").read_text()))
        model = BertG2pw(cfg, device=resolve_device(device)).eval()
        load_state(model, load_npz(base / "g2pw.npz"))
        vocab = {
            tok: i
            for i, tok in enumerate(
                (base / "vocab.txt").read_text(encoding="utf-8").splitlines()
            )
        }
        if has_json:
            catalog = json.loads((base / "polyphone_catalog.json").read_text())
        else:
            # upstream asset: POLYPHONIC_CHARS.txt with bopomofo labels.
            # Labels convert to digit form; the zh pipeline emits them
            # verbatim (final-form bopomofo overrides).
            parsed = parse_polyphone_catalog(
                (base / "POLYPHONIC_CHARS.txt").read_text(encoding="utf-8")
            )
            catalog = {
                ch: {
                    bopomofo_label_to_digit_form(parsed.labels[idx]): idx
                    for idx in idxs
                }
                for ch, idxs in parsed.candidates_by_char.items()
            }
        return cls(model, vocab, catalog)

    def logits(self, chars: str, targets: list[int]):
        """[CLS] chars [SEP] (right-truncated) once per target -> the
        classifier's logits [len(targets), num_labels] as numpy."""
        import numpy as np
        import torch

        unk = self.char_to_id.get("[UNK]", 100)
        ids = [self.char_to_id.get("[CLS]", 101)] + [
            self.char_to_id.get(c, unk) for c in chars[: self.MAX_LENGTH - 2]
        ] + [self.char_to_id.get("[SEP]", 102)]
        T = len(ids)
        B = len(targets)
        dev = self.device
        batch_ids = torch.as_tensor(np.tile(np.asarray(ids, np.int64), (B, 1)), device=dev)
        mask = torch.ones((B, T), dtype=torch.bool, device=dev)
        types = torch.zeros((B, T), dtype=torch.int64, device=dev)
        pos = torch.as_tensor([t + 1 for t in targets], device=dev)  # +1 for [CLS]
        return self.model(batch_ids, mask, types, pos).cpu().numpy()

    def disambiguate(self, chars: str, targets: list[int]) -> dict[int, str]:
        """-> {position: pinyin} for polyphonic targets (others dropped)."""
        import numpy as np

        # drop targets the [CLS]...[SEP] window truncates away (right-side
        # truncation, MandarinBertTokenizer contract) and non-polyphones
        targets = [
            t for t in targets
            if t < self.MAX_LENGTH - 2 and chars[t] in self.catalog
        ]
        if not targets:
            return {}
        logits = self.logits(chars, targets)
        out: dict[int, str] = {}
        for row, t in enumerate(targets):
            cands = self.catalog[chars[t]]  # {pinyin: label_idx}
            items = list(cands.items())
            scores = [logits[row, idx] for _, idx in items]
            out[t] = items[int(np.argmax(scores))][0]
        return out


# ---------------------------------------------------------------------------
# Pinyin -> Bopomofo encoding (reference MandarinBopomofoMap.swift, a port of
# misaki/zh_frontend.py ZH_MAP): each toned syllable becomes
# <initial bopomofo><final bopomofo (or special hanzi token)><tone digit>,
# concatenated with no separators — the exact token stream the
# kokoro-82m ANE-zh vocab expects.
# ---------------------------------------------------------------------------

# multi-char initials first so zh/ch/sh win longest-prefix over z/c/s/h
_INITIALS = [
    "zh", "ch", "sh",
    "b", "p", "m", "f", "d", "t", "n", "l",
    "g", "k", "h", "j", "q", "x",
    "r", "z", "c", "s",
]

_INITIAL_MAP = {
    "b": "ㄅ", "p": "ㄆ", "m": "ㄇ", "f": "ㄈ",
    "d": "ㄉ", "t": "ㄊ", "n": "ㄋ", "l": "ㄌ",
    "g": "ㄍ", "k": "ㄎ", "h": "ㄏ",
    "j": "ㄐ", "q": "ㄑ", "x": "ㄒ",
    "zh": "ㄓ", "ch": "ㄔ", "sh": "ㄕ", "r": "ㄖ",
    "z": "ㄗ", "c": "ㄘ", "s": "ㄙ",
}

# finals; compound finals are hanzi tokens in the v1.1-zh vocab
_FINAL_MAP = {
    "a": "ㄚ", "o": "ㄛ", "e": "ㄜ", "ie": "ㄝ",
    "ai": "ㄞ", "ei": "ㄟ", "ao": "ㄠ", "ou": "ㄡ",
    "an": "ㄢ", "en": "ㄣ", "ang": "ㄤ", "eng": "ㄥ",
    "er": "ㄦ", "i": "ㄧ", "u": "ㄨ", "v": "ㄩ",
    "ii": "ㄭ", "iii": "十",
    "ve": "月", "ia": "压", "ian": "言", "iang": "阳",
    "iao": "要", "in": "阴", "ing": "应", "iong": "用",
    "iou": "又", "ong": "中", "ua": "穵", "uai": "外",
    "uan": "万", "uang": "王", "uei": "为", "uen": "文",
    "ueng": "瓮", "uo": "我", "van": "元", "vn": "云",
}

# punctuation passthrough (ZH_MAP[p] = p in misaki); anything else drops
ALLOWED_PUNCTUATION = set(';:,.!?/—…"()“” ')

# full emit-character set: what a valid bopomofo string may contain
_BOPOMOFO_EMIT_CHARS = (
    set(_INITIAL_MAP.values())
    | set(_FINAL_MAP.values())
    | set("12345")
    | ALLOWED_PUNCTUATION
)

# pypinyin "empty initial" surface forms -> canonical finals
_EMPTY_INITIAL_FORMS = {
    "yi": "i", "ya": "ia", "ye": "ie", "yao": "iao", "you": "iou",
    "yan": "ian", "yin": "in", "yang": "iang", "ying": "ing",
    "yong": "iong",
    "wu": "u", "wa": "ua", "wo": "uo", "wai": "uai", "wei": "uei",
    "wan": "uan", "wen": "uen", "wang": "uang", "weng": "ueng",
    "yu": "v", "yue": "ve", "yuan": "van", "yun": "vn",
}


def _split_tone(syllable: str) -> tuple[str, int]:
    """'hao3' -> ('hao', 3); missing digit -> neutral tone 5."""
    if syllable and syllable[-1].isdigit():
        return syllable[:-1], int(syllable[-1])
    return syllable, 5


def _split_initial_final(syllable: str) -> tuple[str, str]:
    for ini in _INITIALS:
        if syllable.startswith(ini):
            return ini, syllable[len(ini):]
    return "", syllable


def encode_bopomofo(base: str, tone: int, erhua: bool = False) -> str | None:
    """One toned pinyin syllable -> bopomofo + tone digit ('hao',3 ->
    'ㄏㄠ3'); None when unparseable (caller drops, like kokoro's OOV
    behavior). `erhua` appends ㄦ between final and tone digit so the
    model sees one r-coloured tonal unit (ㄒㄧㄠㄦ3)."""
    if not base:
        return None
    normalized = _EMPTY_INITIAL_FORMS.get(base, base)
    initial, final = _split_initial_final(normalized)
    # sibilant i: zi/ci/si -> ii (ㄭ); zhi/chi/shi/ri -> iii (十)
    if final == "i":
        if initial in ("z", "c", "s"):
            final = "ii"
        elif initial in ("zh", "ch", "sh", "r"):
            final = "iii"
    # j/q/x + u -> v: the umlaut is implicit in pinyin orthography
    if initial in ("j", "q", "x") and final.startswith("u"):
        final = "v" + final[1:]
    # written-pinyin contractions ui/un/iu expand to full finals after a
    # consonant initial (gui -> guei, dun -> duen, liu -> liou)
    if initial:
        final = {"ui": "uei", "un": "uen", "iu": "iou"}.get(final, final)
    out = ""
    if initial:
        bo = _INITIAL_MAP.get(initial)
        if bo is None:
            return None
        out += bo
    if final:
        bo = _FINAL_MAP.get(final)
        if bo is None:
            return None
        out += bo
    if erhua:
        out += _FINAL_MAP["er"]
    if 1 <= tone <= 5:
        out += str(tone)
    return out or None


def _encode_pinyin_syllable(syllable: str) -> str | None:
    """Encode a (possibly erhua-merged) pinyin string like 'huar1': any
    base ending in 'r' other than 'er' is an erhua merge, since no
    pinyin final ends in r."""
    base, tone = _split_tone(syllable)
    if base != "er" and len(base) > 1 and base.endswith("r"):
        return encode_bopomofo(base[:-1], tone, erhua=True)
    return encode_bopomofo(base, tone)
