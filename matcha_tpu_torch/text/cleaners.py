"""Text cleaners.

A copy of the JAX package's `matcha_tpu/text/cleaners.py` (the port imports
nothing of that package), which reproduces the reference cleaners: `english_cleaners` =
ascii transliteration -> lowercase -> number expansion -> abbreviation expansion ->
whitespace collapse. Also `basic_cleaners`, `transliteration_cleaners`, and `lowercase`
for cleaner-name dispatch from the tokenizer.
"""

import re

from matcha_tpu_torch.text.numbers import normalize_numbers
from matcha_tpu_torch.text.translit import ascii_transliterate

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(r"\b%s\." % x[0], re.IGNORECASE), x[1])
    for x in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]


def expand_abbreviations(text):
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def expand_numbers(text):
    return normalize_numbers(text)


def lowercase(text):
    return text.lower()


def collapse_whitespace(text):
    return re.sub(_whitespace_re, " ", text)


def convert_to_ascii(text):
    return ascii_transliterate(text)


def basic_cleaners(text):
    """Lowercase + whitespace collapse, no transliteration."""
    text = lowercase(text)
    text = collapse_whitespace(text)
    return text


def transliteration_cleaners(text):
    """ASCII transliteration + lowercase + whitespace collapse."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = collapse_whitespace(text)
    return text


def english_cleaners(text):
    """Full English pipeline with number and abbreviation expansion."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text
