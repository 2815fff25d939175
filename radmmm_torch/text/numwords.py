"""English number verbalization (cardinal/ordinal), dependency-free.

The reference normalizers call the `inflect` package
(tts_text_processing/numerical.py); that package is not available here, so
this module provides the subset of number_to_words behavior the TTS
normalizers need: cardinals with magnitude words and "and"/comma phrasing,
and ordinals.
"""
from __future__ import annotations

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
           (10 ** 3, "thousand"), (100, "hundred")]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _under_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _under_1000(n: int) -> str:
    if n < 100:
        return _under_100(n)
    hundreds, rest = divmod(n, 100)
    out = _ONES[hundreds] + " hundred"
    if rest:
        out += " and " + _under_100(rest)
    return out


def cardinal(n) -> str:
    """Integer or numeric string -> words, inflect-style comma phrasing."""
    n = int(str(n).replace(",", ""))
    if n < 0:
        return "minus " + cardinal(-n)
    if n < 1000:
        return _under_1000(n)
    parts = []
    for scale, name in _SCALES[:-1]:
        if n >= scale:
            q, n = divmod(n, scale)
            parts.append(_under_1000(q) + " " + name)
    if n:
        tail = _under_1000(n)
        if parts and n < 100:
            parts.append("and " + tail)
        else:
            parts.append(tail)
    return ", ".join(parts[:-1]) + (", " if len(parts) > 1 else "") + \
        parts[-1] if parts else "zero"


def number_to_words(value) -> str:
    """Cardinal words for ints, floats, or numeric strings ('3.5', '1,200')."""
    s = str(value).replace(",", "")
    if "." in s:
        whole, frac = s.split(".", 1)
        out = cardinal(whole or "0") + " point " + " ".join(
            _ONES[int(d)] for d in frac if d.isdigit())
        return out
    return cardinal(s)


def ordinal(value) -> str:
    """'21st' / 21 -> 'twenty-first'."""
    s = "".join(c for c in str(value) if c.isdigit())
    words = cardinal(s)
    head, _, last = words.rpartition(" ")
    pre, _, hy_last = last.rpartition("-")
    target = hy_last
    if target in _ORDINAL_IRREGULAR:
        o = _ORDINAL_IRREGULAR[target]
    elif target.endswith("y"):
        o = target[:-1] + "ieth"
    else:
        o = target + "th"
    rebuilt = (pre + "-" if pre else "") + o
    return (head + " " if head else "") + rebuilt


def year_to_words(y: int) -> str:
    """1984 -> 'nineteen eighty-four'; 2007 -> 'two thousand seven'."""
    if 1000 <= y < 2000 or (2010 <= y < 10000 and y % 100 != 0):
        hi, lo = divmod(y, 100)
        if lo == 0:
            return cardinal(hi) + " hundred"
        if lo < 10:
            return cardinal(hi) + " oh " + cardinal(lo)
        return cardinal(hi) + " " + _under_100(lo)
    return cardinal(y)
