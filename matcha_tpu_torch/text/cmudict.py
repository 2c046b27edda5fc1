"""CMU pronouncing dictionary frontend.

A copy of the JAX package's `matcha_tpu/text/cmudict.py` (the port imports
nothing of that package), with its own copy of the data file `cmudict-0.7b`:
parses the file (latin-1), maps WORD -> list of ARPAbet pronunciation strings,
collapses the `(n)` alternate markers, and drops entries containing
non-ARPAbet tokens.
"""

import os
import re

valid_symbols = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0", "AH1", "AH2",
    "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2", "AY", "AY0", "AY1", "AY2",
    "B", "CH", "D", "DH", "EH", "EH0", "EH1", "EH2", "ER", "ER0", "ER1", "ER2", "EY",
    "EY0", "EY1", "EY2", "F", "G", "HH", "IH", "IH0", "IH1", "IH2", "IY", "IY0", "IY1",
    "IY2", "JH", "K", "L", "M", "N", "NG", "OW", "OW0", "OW1", "OW2", "OY", "OY0",
    "OY1", "OY2", "P", "R", "S", "SH", "T", "TH", "UH", "UH0", "UH1", "UH2", "UW",
    "UW0", "UW1", "UW2", "V", "W", "Y", "Z", "ZH",
]

_VALID_SYMBOL_SET = set(valid_symbols)
_ALT_RE = re.compile(r"\([0-9]+\)")

DEFAULT_DICT_PATH = os.path.join(os.path.dirname(__file__), "cmudict-0.7b")


class CMUDict:
    """Word -> ARPAbet pronunciation lookup."""

    def __init__(self, file_or_path=None, keep_ambiguous=True):
        if file_or_path is None:
            file_or_path = DEFAULT_DICT_PATH
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = _parse_cmudict(f)
        else:
            entries = _parse_cmudict(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self):
        return len(self._entries)

    def lookup(self, word):
        """Return the list of ARPAbet pronunciations for ``word`` (None if absent)."""
        return self._entries.get(word.upper())


def _parse_cmudict(file):
    entries = {}
    for line in file:
        # Valid entries start with A-Z or an apostrophe; comments/symbols are skipped.
        if len(line) and ("A" <= line[0] <= "Z" or line[0] == "'"):
            parts = line.split("  ")
            word = _ALT_RE.sub("", parts[0])
            pronunciation = _validate_pronunciation(parts[1])
            if pronunciation:
                entries.setdefault(word, []).append(pronunciation)
    return entries


def _validate_pronunciation(s):
    parts = s.strip().split(" ")
    for part in parts:
        if part not in _VALID_SYMBOL_SET:
            return None
    return " ".join(parts)
