"""Text frontend: language detection, normalization/splitting, emotion-tag
parsing, phoneme (IPA) marking, property descriptions.

Reference parity (C19, /root/reference):
  * language detect (utils/tts_util.py:8-15 uses langdetect; here a
    unicode-range heuristic — zh iff CJK chars dominate)
  * normalization + paragraph split by token count (cosyvoice
    cli/frontend.py:124-152; WeTextProcessing's zh/en TN models are
    optional runtime deps — the native TN rules in data/zh_tn.py verbalize
    digits/dates/units when they are absent)
  * emotion-tag rewriting (utils/text_processor.py: "(happy) text" ->
    natural-language emotion prefix form)
  * IPA phoneme marking for pronunciation-controllable finetuning
    (utils/phonem_utils.py:114-232 — natural pronunciation tags;
    pypinyin/eng_to_ipa when installed, else the native char->TONE3 table
    (data/pinyin.py) and rule G2P (data/en_g2p.py))
  * instruction templates + property descriptions (tts_util.py:70-81)
"""
from __future__ import annotations

import re
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

INSTRUCTION = (
    "User: Please generate the speech according to the following text: {text}\nAssistant:"
)
INSTRUCTION_WITH_PROPERTIES = (
    "User: Please generate the speech with the properties: {properties} "
    "according to the following text: {text}\nAssistant:"
)


# ---------------------------------------------------------------------------
# Language detection


def detect_language(text: str) -> str:
    """'zh' iff CJK characters dominate the letters, else 'en'."""
    cjk = sum(1 for c in text if "一" <= c <= "鿿")
    latin = sum(1 for c in text if c.isascii() and c.isalpha())
    return "zh" if cjk >= max(latin / 4, 1) else "en"


def contains_chinese(text: str) -> bool:
    return any("一" <= c <= "鿿" for c in text)


# ---------------------------------------------------------------------------
# Normalization + paragraph splitting


_ZH_END = "。！？；"
_EN_END = ".!?;"


def basic_normalize(text: str, lang: Optional[str] = None) -> str:
    """Text normalization: WeTextProcessing when installed (the reference's
    normalizer, cli/frontend.py:124-152), else the native TN rules
    (data/zh_tn.py) — digits/dates/units ARE verbalized either way."""
    lang = lang or detect_language(text)
    text = text.strip().replace("\n", "")
    try:  # optional heavy normalizers
        if lang == "zh":
            from tn.chinese.normalizer import Normalizer  # type: ignore

            text = Normalizer().normalize(text)
        else:
            from tn.english.normalizer import Normalizer  # type: ignore

            text = Normalizer().normalize(text)
    except Exception:
        from rwkvtts_tpu.data import zh_tn

        text = zh_tn.normalize_zh(text) if lang == "zh" else zh_tn.normalize_en(text)
    if lang == "zh":
        text = re.sub(r"\s+", "", text)
        text = text.replace(".", "。").replace(" - ", "，")
        text = re.sub(r"[，,、]+$", "。", text)
    else:
        text = re.sub(r"\s+", " ", text)
    return text


def split_paragraph(
    text: str,
    encode_fn: Callable[[str], Sequence[int]],
    lang: Optional[str] = None,
    token_max_n: int = 80,
    token_min_n: int = 60,
    merge_len: int = 20,
) -> List[str]:
    """Sentence-boundary split keeping chunks within a token budget
    (cli/frontend.py split_paragraph semantics)."""
    lang = lang or detect_language(text)
    ends = _ZH_END if lang == "zh" else _EN_END
    # sentence segmentation
    sents: List[str] = []
    buf = ""
    for c in text:
        buf += c
        if c in ends:
            sents.append(buf)
            buf = ""
    if buf.strip():
        sents.append(buf)

    chunks: List[str] = []
    cur = ""
    for s in sents:
        if cur and len(encode_fn(cur + s)) > token_max_n:
            chunks.append(cur)
            cur = s
        else:
            cur += s
    if cur:
        # merge a tiny tail into the previous chunk
        if chunks and len(encode_fn(cur)) < merge_len:
            chunks[-1] += cur
        else:
            chunks.append(cur)
    return [c for c in chunks if any(not unicodedata.category(ch).startswith("P") and not ch.isspace() for ch in c)]


# ---------------------------------------------------------------------------
# Emotion-tag rewriting (text_processor.py behavior)


_EMOTION_WORDS = {
    "happy", "sad", "angry", "excited", "calm", "fearful", "surprised",
    "disgusted", "neutral", "whisper", "shout",
}


def parse_emotion_and_text(text: str) -> Tuple[Optional[str], str]:
    """'(happy) hello there' -> ('happy', 'hello there'); no-tag text passes
    through."""
    m = re.match(r"^\s*[\(（]([^\)）]{1,24})[\)）]\s*(.*)$", text, re.S)
    if not m:
        return None, text
    tag = m.group(1).strip().lower()
    if tag in _EMOTION_WORDS or contains_chinese(tag):
        return tag, m.group(2)
    return None, text


def rewrite_with_emotion(text: str) -> str:
    """Natural-language emotion prefix form used for instruction-augmented
    training rows."""
    emotion, content = parse_emotion_and_text(text)
    if emotion is None:
        return text
    if contains_chinese(content):
        return f"用{emotion}的情绪说：{content}"
    return f"Say it in a {emotion} voice: {content}"


# ---------------------------------------------------------------------------
# IPA phoneme marking (pronunciation-controllable ft)


def to_ipa(word: str, lang: str = "en", strict: bool = False) -> str:
    """Word -> pronunciation string.

    en: eng_to_ipa when installed, else the native G2P (exception dict +
    letter rules, data/en_g2p.py). zh: pypinyin TONE3 when installed, else
    the native char->TONE3 table (data/pinyin.py, ~2950 chars).

    Both native paths are real pronunciation models, so the ipa-ft trainer
    accepts them (`strict=True`). strict only raises when a zh char falls
    OUTSIDE the native table — training on a pass-through char would teach
    a garbage (char, pronunciation) pair."""
    if lang == "en":
        try:
            import eng_to_ipa  # type: ignore

            return eng_to_ipa.convert(word)
        except Exception:
            from rwkvtts_tpu.data import en_g2p

            return en_g2p.convert(word)
    try:
        from pypinyin import lazy_pinyin  # type: ignore

        return " ".join(lazy_pinyin(word, style=8))  # Style.TONE3
    except Exception:
        from rwkvtts_tpu.data import pinyin

        readings = []
        for c in word:
            py = pinyin.char_to_tone3(c)
            if py is None:
                if strict and "一" <= c <= "鿿":
                    raise RuntimeError(
                        f"zh char {c!r} is outside the native pinyin table; "
                        "refusing to mark it with a non-pronunciation "
                        "(install pypinyin or extend assets/zh_pinyin.tsv)"
                    )
                readings.append(c)
            else:
                readings.append(py)
        return " ".join(readings)


def mark_phonemes(
    text: str,
    lang: Optional[str] = None,
    max_mark: int = 1,
    rng=None,
    strict: bool = False,
) -> str:
    """Mark up to `max_mark` words/chars with their pronunciation in the
    natural-tagged format the ipa-ft trainer consumes:
    'hello world' -> 'hello world(pronounced as /wɝld/)'.

    strict=True (trainer path) raises instead of silently marking with the
    letter-map fallback when the IPA deps are missing."""
    import random as _random

    rng = rng or _random.Random(0)
    lang = lang or detect_language(text)
    if lang == "en":
        words = text.split()
        if not words:
            return text
        idxs = sorted(rng.sample(range(len(words)), min(max_mark, len(words))))
        for i in idxs:
            w = re.sub(r"\W", "", words[i])
            if w:
                words[i] = f"{words[i]}(pronounced as /{to_ipa(w, 'en', strict=strict)}/)"
        return " ".join(words)
    chars = [c for c in text]
    cands = [i for i, c in enumerate(chars) if "一" <= c <= "鿿"]
    if not cands:
        return text
    for i in sorted(rng.sample(cands, min(max_mark, len(cands)))):
        chars[i] = f"{chars[i]}(读作{to_ipa(chars[i], 'zh', strict=strict)})"
    return "".join(chars)
