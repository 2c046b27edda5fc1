"""Text frontend of the port: the three tokenizers of the JAX package.

`text_to_sequence` is the full pipeline: cleaners by name, `{ARPAbet}`
segments mapped to `@`-prefixed symbols (`cmudict.valid_symbols`), EOS
appended; `sequence_to_text` inverts it. `simple_text_to_sequence`
(lowercase + char map) is what inference calls; `train_text_to_sequence`
(`english_cleaners`, then the char map) is what the training data path
calls. The last two drop unknown characters and append no EOS.
"""

import re

from matcha_tpu_torch.text import cleaners
from matcha_tpu_torch.text.cleaners import english_cleaners
from matcha_tpu_torch.text.symbols import EOS, EOS_ID, ID_TO_SYMBOL, PAD, SYMBOL_TO_ID, symbols

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")

__all__ = ["symbols", "cleaners", "english_cleaners", "text_to_sequence", "sequence_to_text",
           "simple_text_to_sequence", "train_text_to_sequence"]


def text_to_sequence(text, cleaner_names):
    """Full tokenizer: cleaners by name, `{ARPAbet}` segments, EOS appended."""
    sequence = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(_clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)
    sequence.append(EOS_ID)
    return sequence


def sequence_to_text(sequence):
    """Inverse of `text_to_sequence`; ARPAbet ids are re-wrapped in curly braces."""
    result = ""
    for symbol_id in sequence:
        if symbol_id in ID_TO_SYMBOL:
            s = ID_TO_SYMBOL[symbol_id]
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            result += s
    return result.replace("}{", " ")


def simple_text_to_sequence(text, cleaner_names=None):
    """Lowercase + direct char map, unknown characters dropped, no EOS."""
    del cleaner_names  # accepted for API compatibility, unused
    return [SYMBOL_TO_ID[ch] for ch in text.lower() if ch in SYMBOL_TO_ID]


def train_text_to_sequence(text):
    """Training-data tokenizer: english_cleaners, then char -> id, no EOS."""
    return [SYMBOL_TO_ID[ch] for ch in english_cleaners(text) if ch in SYMBOL_TO_ID]


def _clean_text(text, cleaner_names):
    for name in cleaner_names:
        cleaner = getattr(cleaners, name, None)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def _symbols_to_sequence(syms):
    return [SYMBOL_TO_ID[s] for s in syms if _should_keep_symbol(s)]


def _arpabet_to_sequence(text):
    return _symbols_to_sequence(["@" + s for s in text.split()])


def _should_keep_symbol(s):
    return s in SYMBOL_TO_ID and s != PAD and s != EOS
