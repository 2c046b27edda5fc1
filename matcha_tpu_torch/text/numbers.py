"""Number normalization for English text.

A copy of the JAX package's `matcha_tpu/text/numbers.py` (the port imports nothing of
that package). The reference normalizer delegates word generation to the `inflect`
package; this module needs no package and ships its own English number-to-words engine producing identical output for the forms the TTS
frontend exercises (cardinals without 'and', ordinals with 'and', two-digit year grouping
with 'oh', money and decimals).
"""

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
    "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
_SCALES = [
    "", "thousand", "million", "billion", "trillion", "quadrillion", "quintillion",
    "sextillion", "septillion", "octillion", "nonillion", "decillion",
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits_to_words(n):
    """0..99 -> words ('twenty-four')."""
    if n < 20:
        return _UNITS[n]
    tens, unit = divmod(n, 10)
    if unit == 0:
        return _TENS[tens]
    return f"{_TENS[tens]}-{_UNITS[unit]}"


def _three_digits_to_words(n, andword=""):
    """0..999 -> words; `andword` joins hundreds and the remainder when non-empty."""
    if n < 100:
        return _two_digits_to_words(n)
    hundreds, rest = divmod(n, 100)
    head = f"{_UNITS[hundreds]} hundred"
    if rest == 0:
        return head
    joiner = f" {andword} " if andword else " "
    return head + joiner + _two_digits_to_words(rest)


def number_to_words(num, andword="and", zero="zero", group=0):
    """English words for an integer.

    Args:
        num: int or decimal-digit string.
        andword: word between 'hundred' and the remainder ('' to omit).
        zero: word used for the digit/value zero.
        group: 0 for ordinary cardinals; 2 for two-digit grouping (year style),
            matching the reference's `_inflect.number_to_words(num, group=2)` usage.
    """
    digits = str(num)
    if group == 2:
        pairs = [digits[i:i + 2] for i in range(0, len(digits), 2)]
        words = []
        for pair in pairs:
            if len(pair) == 1:
                words.append(zero if pair == "0" else _UNITS[int(pair)])
            elif pair[0] == "0":
                second = zero if pair[1] == "0" else _UNITS[int(pair[1])]
                words.append(f"{zero} {second}")
            else:
                words.append(_two_digits_to_words(int(pair)))
        return ", ".join(words)

    n = int(num)
    if n == 0:
        return zero
    if n < 0:
        return "minus " + number_to_words(-n, andword=andword, zero=zero)

    groups = []
    scale_idx = 0
    while n > 0:
        n, chunk = divmod(n, 1000)
        if chunk:
            words = _three_digits_to_words(chunk, andword=andword)
            scale = _SCALES[scale_idx]
            groups.append(f"{words} {scale}".strip())
        scale_idx += 1
    return " ".join(reversed(groups))


def ordinal_words(num, andword="and"):
    """English ordinal words for an integer ('243' -> 'two hundred and forty-third')."""
    cardinal = number_to_words(num, andword=andword)
    # Convert the final word to its ordinal form.
    head, sep, last = cardinal.rpartition(" ")
    prefix = head + sep
    if "-" in last:
        tens, hy, unit = last.rpartition("-")
        prefix += tens + hy
        last = unit
    if last in _ORDINAL_IRREGULAR:
        last = _ORDINAL_IRREGULAR[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return prefix + last


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"  # Unexpected format
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    elif dollars:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        return f"{dollars} {dollar_unit}"
    elif cents:
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{cents} {cent_unit}"
    return "zero dollars"


def _expand_ordinal(m):
    num = int(re.sub(r"(st|nd|rd|th)$", "", m.group(0)))
    return ordinal_words(num)


def _expand_number(m):
    """Cardinal expansion with the reference's special-case year logic for 1000<n<3000."""
    num = int(m.group(0))
    if num > 1000 and num < 3000:
        if num == 2000:
            return "two thousand"
        elif num > 2000 and num < 2010:
            return "two thousand " + number_to_words(num % 100)
        elif num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        else:
            return number_to_words(num, andword="", zero="oh", group=2).replace(", ", " ")
    return number_to_words(num, andword="")


def normalize_numbers(text):
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
