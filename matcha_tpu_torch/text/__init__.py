"""Text frontend of the port: the inference tokenizer and the training-data tokenizer.

`simple_text_to_sequence` (lowercase + char map) is what inference calls;
`train_text_to_sequence` (`english_cleaners`, then the char map) is what the
training data path calls. Both drop unknown characters and append no EOS.
cmudict and the ARPAbet `text_to_sequence` are not ported yet (ROADMAP M5).
"""

from matcha_tpu_torch.text import cleaners
from matcha_tpu_torch.text.cleaners import english_cleaners
from matcha_tpu_torch.text.symbols import SYMBOL_TO_ID, symbols

__all__ = ["symbols", "cleaners", "english_cleaners", "simple_text_to_sequence",
           "train_text_to_sequence"]


def simple_text_to_sequence(text, cleaner_names=None):
    """Lowercase + direct char map, unknown characters dropped, no EOS."""
    del cleaner_names  # accepted for API compatibility, unused
    return [SYMBOL_TO_ID[ch] for ch in text.lower() if ch in SYMBOL_TO_ID]


def train_text_to_sequence(text):
    """Training-data tokenizer: english_cleaners, then char -> id, no EOS."""
    return [SYMBOL_TO_ID[ch] for ch in english_cleaners(text) if ch in SYMBOL_TO_ID]
