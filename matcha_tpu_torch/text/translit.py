"""ASCII transliteration.

A copy of the JAX package's `matcha_tpu/text/translit.py` (the port imports nothing of
that package). It replaces the `unidecode` dependency of the reference cleaners, so the
port needs no package for it. Covers Latin diacritics (via NFKD decomposition), the common Latin special
letters, Cyrillic, Greek, and Hangul (algorithmic jamo decomposition + revised
romanization as used by unidecode), which is sufficient for the English TTS pipeline and
the reference's own test vectors. Unknown non-ASCII characters are dropped.
"""

import unicodedata

_LATIN_SPECIAL = {
    "ß": "ss", "ẞ": "SS", "Æ": "AE", "æ": "ae", "Œ": "OE", "œ": "oe",
    "Ø": "O", "ø": "o", "Đ": "D", "đ": "d", "Þ": "Th", "þ": "th",
    "Ð": "D", "ð": "d", "Ł": "L", "ł": "l", "ı": "i", "Ħ": "H", "ħ": "h",
    "Ŋ": "NG", "ŋ": "ng", "Ŧ": "T", "ŧ": "t", "ĸ": "k",
    "’": "'", "‘": "'", "“": '"', "”": '"', "–": "-", "—": "-", "…": "...",
    " ": " ",
}

_CYRILLIC = {
    "А": "A", "Б": "B", "В": "V", "Г": "G", "Д": "D", "Е": "E", "Ё": "Io",
    "Ж": "Zh", "З": "Z", "И": "I", "Й": "I", "К": "K", "Л": "L", "М": "M",
    "Н": "N", "О": "O", "П": "P", "Р": "R", "С": "S", "Т": "T", "У": "U",
    "Ф": "F", "Х": "Kh", "Ц": "Ts", "Ч": "Ch", "Ш": "Sh", "Щ": "Shch",
    "Ъ": "", "Ы": "Y", "Ь": "", "Э": "E", "Ю": "Iu", "Я": "Ia",
    "а": "a", "б": "b", "в": "v", "г": "g", "д": "d", "е": "e", "ё": "io",
    "ж": "zh", "з": "z", "и": "i", "й": "i", "к": "k", "л": "l", "м": "m",
    "н": "n", "о": "o", "п": "p", "р": "r", "с": "s", "т": "t", "у": "u",
    "ф": "f", "х": "kh", "ц": "ts", "ч": "ch", "ш": "sh", "щ": "shch",
    "ъ": "", "ы": "y", "ь": "", "э": "e", "ю": "iu", "я": "ia",
    "Є": "Ie", "є": "ie", "І": "I", "і": "i", "Ї": "Yi", "ї": "yi",
    "Ґ": "G", "ґ": "g",
}

_GREEK = {
    "Α": "A", "Β": "B", "Γ": "G", "Δ": "D", "Ε": "E", "Ζ": "Z", "Η": "E",
    "Θ": "Th", "Ι": "I", "Κ": "K", "Λ": "L", "Μ": "M", "Ν": "N", "Ξ": "X",
    "Ο": "O", "Π": "P", "Ρ": "R", "Σ": "S", "Τ": "T", "Υ": "U", "Φ": "Ph",
    "Χ": "Kh", "Ψ": "Ps", "Ω": "O",
    "α": "a", "β": "b", "γ": "g", "δ": "d", "ε": "e", "ζ": "z", "η": "e",
    "θ": "th", "ι": "i", "κ": "k", "λ": "l", "μ": "m", "ν": "n", "ξ": "x",
    "ο": "o", "π": "p", "ρ": "r", "σ": "s", "ς": "s", "τ": "t", "υ": "u",
    "φ": "ph", "χ": "kh", "ψ": "ps", "ω": "o",
}

# Revised-romanization tables for Hangul jamo (matches unidecode's output).
_HANGUL_LEADS = ["g", "kk", "n", "d", "tt", "r", "m", "b", "pp", "s", "ss", "",
                 "j", "jj", "ch", "k", "t", "p", "h"]
_HANGUL_VOWELS = ["a", "ae", "ya", "yae", "eo", "e", "yeo", "ye", "o", "wa", "wae",
                  "oe", "yo", "u", "wo", "we", "wi", "yu", "eu", "ui", "i"]
_HANGUL_TAILS = ["", "g", "kk", "gs", "n", "nj", "nh", "d", "l", "lg", "lm", "lb",
                 "ls", "lt", "lp", "lh", "m", "b", "bs", "s", "ss", "ng", "j", "c",
                 "k", "t", "p", "h"]

_HANGUL_BASE = 0xAC00
_HANGUL_END = 0xD7A3


def _hangul_to_ascii(ch):
    code = ord(ch) - _HANGUL_BASE
    lead, rest = divmod(code, 21 * 28)
    vowel, tail = divmod(rest, 28)
    return _HANGUL_LEADS[lead] + _HANGUL_VOWELS[vowel] + _HANGUL_TAILS[tail]


def ascii_transliterate(text):
    """Best-effort transliteration of arbitrary unicode text to ASCII."""
    out = []
    for ch in text:
        o = ord(ch)
        if o < 128:
            out.append(ch)
            continue
        if ch in _LATIN_SPECIAL:
            out.append(_LATIN_SPECIAL[ch])
            continue
        if ch in _CYRILLIC:
            out.append(_CYRILLIC[ch])
            continue
        if ch in _GREEK:
            out.append(_GREEK[ch])
            continue
        if _HANGUL_BASE <= o <= _HANGUL_END:
            out.append(_hangul_to_ascii(ch))
            continue
        # Generic path: strip combining marks after compatibility decomposition.
        decomposed = unicodedata.normalize("NFKD", ch)
        stripped = "".join(c for c in decomposed if not unicodedata.combining(c))
        if stripped and all(ord(c) < 128 for c in stripped):
            out.append(stripped)
        # else: drop the character (no ASCII equivalent known).
    return "".join(out)
