"""The port's text frontend (`matcha_tpu_torch.text`) against `matcha_tpu.text`.

Every vector of tests/test_text.py's tokenizer and cmudict tests gives the
same ids, text or lookups in both packages; the real dictionary parses to the
same entries; the port's copy of `cmudict-0.7b` is the JAX package's, byte for
byte; an unknown cleaner raises in both.
"""

import functools
import hashlib
import importlib
import io
from pathlib import Path

import pytest

from matcha_tpu import text as jt
from matcha_tpu.text import cmudict as jcmu
from matcha_tpu_torch import text as pt
from matcha_tpu_torch.text import cmudict as pcmu
from tests.test_text import CMUDICT_TEST_DATA

# the modules (each package's `symbols` attribute is the list)
jsym = importlib.import_module("matcha_tpu.text.symbols")
psym = importlib.import_module("matcha_tpu_torch.text.symbols")

ROOT = Path(__file__).resolve().parents[1]

# (text, cleaner names, ids): tests/test_text.py::test_text_to_sequence
TO_SEQUENCE = [
    ("", [], [1]),
    ("Hi!", [], [10, 37, 55, 1]),
    ('"A"_B', [], [3, 4, 1]),
    ("A {AW1 S} B", [], [3, 65, 84, 133, 65, 4, 1]),
    ("Hi", ["lowercase"], [36, 37, 1]),
    ("A {AW1 S}  B", ["english_cleaners"], [29, 65, 84, 133, 65, 30, 1]),
    # beyond the reference vectors: two ARPAbet segments, basic and transliteration cleaners
    ("{HH AH0 L OW1}{W ER1 L D}, Mr. Müller!", ["english_cleaners"], None),
    ("Über {K AE1 T} 2", ["transliteration_cleaners"], None),
    ("Über {K AE1 T} 2", ["basic_cleaners"], None),
]
# (ids, text): tests/test_text.py::test_sequence_to_text
TO_TEXT = [([], ""), ([1], "~"), ([10, 37, 55, 1], "Hi!~"),
           ([3, 65, 84, 133, 65, 4], "A {AW1 S} B"),
           ([65, 84, 65, 133, 65, 60, 1], None)]  # adjacent ARPAbet segments joined by a space
# (keep_ambiguous, word): test_cmudict, test_cmudict_no_keep_ambiguous
LOOKUPS = [(keep, w) for keep in (True, False)
           for w in ("ADVERSITY", "BarberShop", "You'll", "'tis", "adverse", "", "foo", ")paren",
                     "adversely")]


@pytest.mark.parametrize(
    "case",
    [("to_sequence",) + c for c in TO_SEQUENCE] + [("to_text",) + c for c in TO_TEXT]
    + [("cmudict",) + c for c in LOOKUPS] + [("real_file", w) for w in ("HELLO", "zyzzyva")],
    ids=lambda c: "-".join(str(p) for p in c[:2]))
def test_same_as_jax_package(case):
    kind = case[0]
    if kind == "to_sequence":
        text, cleaners, want = case[1:]
        got = pt.text_to_sequence(text, cleaners)
        assert got == jt.text_to_sequence(text, cleaners)
        assert want is None or got == want
    elif kind == "to_text":
        ids, want = case[1:]
        got = pt.sequence_to_text(ids)
        assert got == jt.sequence_to_text(ids)
        assert want is None or got == want
    elif kind == "cmudict":
        keep, word = case[1:]
        port = pcmu.CMUDict(io.StringIO(CMUDICT_TEST_DATA), keep_ambiguous=keep)
        ref = jcmu.CMUDict(io.StringIO(CMUDICT_TEST_DATA), keep_ambiguous=keep)
        assert len(port) == len(ref) == (6 if keep else 5)
        assert port.lookup(word) == ref.lookup(word)
    else:
        assert _real_port().lookup(case[1]) == _real_jax().lookup(case[1])


@functools.cache
def _real_port():
    return pcmu.CMUDict()


@functools.cache
def _real_jax():
    return jcmu.CMUDict()


def test_real_dictionary_parses_to_the_same_entries():
    port, ref = _real_port(), _real_jax()
    assert len(port) > 100_000
    assert port._entries == ref._entries
    assert port.lookup("HELLO") == ["HH AH0 L OW1", "HH EH0 L OW1"]


def test_dictionary_file_is_a_byte_identical_copy():
    def sha(path):
        return hashlib.sha256(path.read_bytes()).hexdigest()

    assert Path(pcmu.DEFAULT_DICT_PATH).parent == ROOT / "matcha_tpu_torch" / "text"
    assert sha(Path(pcmu.DEFAULT_DICT_PATH)) == sha(Path(jcmu.DEFAULT_DICT_PATH))


def test_symbol_tables_match():
    assert pcmu.valid_symbols == jcmu.valid_symbols and len(pcmu.valid_symbols) == 84
    assert psym.symbols == jsym.symbols
    assert psym.ID_TO_SYMBOL == jsym.ID_TO_SYMBOL
    assert (psym.PAD, psym.EOS, psym.PAD_ID, psym.EOS_ID, psym.UNK_ID) == \
        (jsym.PAD, jsym.EOS, jsym.PAD_ID, jsym.EOS_ID, jsym.UNK_ID)


def test_unknown_cleaner_raises():
    for tokenize in (pt.text_to_sequence, jt.text_to_sequence):
        with pytest.raises(ValueError, match="Unknown cleaner: no_such_cleaner"):
            tokenize("hello", ["no_such_cleaner"])
