"""Text frontend of the port: the inference tokenizer only.

Cleaners, cmudict and number expansion are not ported yet (ROADMAP M5).
"""

from matcha_tpu_torch.text.symbols import SYMBOL_TO_ID, symbols

__all__ = ["symbols", "simple_text_to_sequence"]


def simple_text_to_sequence(text, cleaner_names=None):
    """Lowercase + direct char map, unknown characters dropped, no EOS."""
    del cleaner_names  # accepted for API compatibility, unused
    return [SYMBOL_TO_ID[ch] for ch in text.lower() if ch in SYMBOL_TO_ID]
