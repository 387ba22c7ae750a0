"""VQA answer normalization and scoring (a copy of
``attwarp_tpu/eval/vqa_text.py``: the JAX ``eval`` package imports its
harness, and that imports JAX; ``tests/test_torch_eval.py`` pins the copy).

Behavioral parity with ``evaluate_accuracy.py:33-114,248-272`` — which is
itself the standard published VQA-v2 evaluation normalization (contractions
table, digit map, article removal, punctuation rules) plus the reference's
additions: the "no.1"/"number.1" special cases, the periods-first ordering,
and the binary threshold variant. Pure string processing; must stay
bit-identical to the reference (SURVEY §2 C15), including its quirks:

- ``periodStrip.sub(" ", text, re.UNICODE)`` passes ``re.UNICODE`` (=32) as
  the COUNT argument, so only the first 32 periods are replaced;
- the punctuation-context conditions test the ORIGINAL input string, not the
  partially-processed one.
"""

from __future__ import annotations

import re
from typing import List, Sequence

# The published VQA contraction table (word-without-apostrophe -> contraction).
_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

_MANUAL_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

_ARTICLES = ("a", "an", "the")

_PERIOD_STRIP = re.compile(r"(?<!\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")
_PUNCT = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
    "-", ">", "<", "@", "`", ",", "?", "!",
]


def process_punctuation(text: str) -> str:
    out = text
    # Quirk preserved: re.UNICODE (=32) lands in the COUNT argument, so at
    # most 32 non-numeric periods are stripped (evaluate_accuracy.py:65).
    out = _PERIOD_STRIP.sub(" ", out, re.UNICODE)
    for p in _PUNCT:
        # Conditions intentionally test the ORIGINAL string (reference :69).
        if (p + " " in text or " " + p in text) or _COMMA_STRIP.search(text) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return re.sub(r"\s+", " ", out).strip()


def process_digit_article(text: str) -> str:
    words: List[str] = []
    for word in text.lower().split():
        word = _MANUAL_MAP.get(word, word)
        if word not in _ARTICLES:
            words.append(word)
    for i, word in enumerate(words):
        if word in _CONTRACTIONS:
            words[i] = _CONTRACTIONS[word]
    return " ".join(words)


def process_text(text: str) -> str:
    """Full normalization incl. the no.1/number.1 special cases
    (evaluate_accuracy.py:93-108)."""
    text = text.lower()
    text = re.sub(r"no\s*\.\s*(\d+)", r"no \1", text)
    text = re.sub(r"no\s+(\d+)", r"no \1", text)
    text = re.sub(r"number\s*\.\s*(\d+)", r"number \1", text)
    text = re.sub(r"number\s+(\d+)", r"number \1", text)
    text = process_punctuation(text)
    text = process_digit_article(text)
    return text


def get_acc(pred: str, gts: Sequence[str]) -> float:
    """VQA accuracy: 100 * min(0.33333 * #matching-GT, 1)
    (evaluate_accuracy.py:110-114)."""
    p = process_text(pred)
    gts_n = [process_text(g) for g in gts]
    same = sum(1 for g in gts_n if g == p)
    return 100 * min(0.33333 * same, 1)


def calculate_vqa_accuracy(
    predicted_answer: str, ground_truth_answers: Sequence[str], threshold: int = 3
) -> bool:
    """Binary variant: #matches >= threshold (evaluate_accuracy.py:248-272);
    the harness calls it with threshold=1 (:360)."""
    if not predicted_answer or not ground_truth_answers:
        return False
    p = process_text(predicted_answer)
    gts = [process_text(g) for g in ground_truth_answers]
    return sum(1 for g in gts if g == p) >= threshold
