"""Text normalization: numbers, currency, dates/times, abbreviations,
letters+numbers, transliteration.

Behavioral equivalents of tts_text_processing/{numerical, abbreviations,
datestime, letters_and_numbers}.py, implemented dependency-free (the
reference uses `inflect` and `unidecode`, absent here — see numwords.py and
the transliteration table below).
"""
from __future__ import annotations

import re

from radmmm_torch.text.numwords import number_to_words, ordinal

# ---------------------------------------------------------------------------
# numbers / currency
# ---------------------------------------------------------------------------
_MAGNITUDES = ["trillion", "billion", "million", "thousand", "hundred",
               "m", "b", "t"]
_MAGNITUDE_KEY = {"m": "million", "b": "billion", "t": "trillion"}
_MEASUREMENT_KEY = {"f": "fahrenheit", "c": "celsius", "k": "thousand",
                    "m": "meters"}
_CURRENCY_KEY = {"$": "dollar", "£": "pound", "€": "euro", "₩": "won"}

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_re = re.compile(r"([0-9]+\.[0-9]+)")
_currency_re = re.compile(
    r"([\$€£₩])([0-9\.\,]*[0-9]+)(?:[ ]?({})(?=[^a-zA-Z]))?".format(
        "|".join(_MAGNITUDES)), re.IGNORECASE)
_measurement_re = re.compile(
    r"([0-9\.\,]*[0-9]+(\s)?(f|c|k|d|m)\b)", re.IGNORECASE)
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_multiply_re = re.compile(r"(\b[0-9]+)(x)([0-9]+)")
_number_re = re.compile(r"[0-9]+'s|[0-9]+s|[0-9]+")


def _expand_hundreds_style(text: str) -> str:
    """'1200' -> 'twelve hundred' when it reads naturally."""
    number = float(text)
    if 1000 < number < 10000 and number % 100 == 0 and number % 1000 != 0:
        return number_to_words(int(number / 100)) + " hundred"
    return number_to_words(text)


def _currency_sub(m: re.Match) -> str:
    unit = _CURRENCY_KEY[m.group(1)]
    quantity = m.group(2).replace(",", "")
    magnitude = m.group(3)
    if magnitude is not None and magnitude.lower() in _MAGNITUDES:
        if len(magnitude) == 1:
            magnitude = _MAGNITUDE_KEY[magnitude.lower()]
        return f"{_expand_hundreds_style(quantity)} {magnitude} {unit}s"
    parts = quantity.split(".")
    if len(parts) > 2:
        return quantity + " " + unit + "s"
    whole = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if whole and cents:
        unit_w = unit if whole == 1 else unit + "s"
        unit_c = "cent" if cents == 1 else "cents"
        return (f"{_expand_hundreds_style(whole)} {unit_w}, "
                f"{number_to_words(cents)} {unit_c}")
    if whole:
        return f"{_expand_hundreds_style(whole)} " + (
            unit if whole == 1 else unit + "s")
    if cents:
        return f"{number_to_words(cents)} " + (
            "cent" if cents == 1 else "cents")
    return f"zero {unit}s"


def _measurement_sub(m: re.Match) -> str:
    _, number, unit = re.split(r"(\d+(?:\.\d+)?)", m.group(0))
    unit = "".join(unit.split()).lower()
    return "{} {}".format(number_to_words(number),
                          _MEASUREMENT_KEY.get(unit, unit))


def _number_sub(m: re.Match) -> str:
    text = m.group(0)
    if text.endswith("'s") or text.endswith("s"):
        base = text.rstrip("s").rstrip("'")
        words = number_to_words(base)
        # pluralize the final word ('1950s' -> 'nineteen fifties' handled
        # upstream by letters_and_numbers; keep simple plural here)
        if words.endswith("y"):
            return words[:-1] + "ies"
        return words + "s"
    return number_to_words(text)


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, lambda m: m.group(1).replace(",", ""),
                  text)
    text = re.sub(_decimal_re,
                  lambda m: m.group(1).replace(".", " point "), text)
    text = re.sub(_measurement_re, _measurement_sub, text)
    text = re.sub(_ordinal_re, lambda m: ordinal(m.group(0)), text)
    text = re.sub(_multiply_re,
                  lambda m: f"{m.group(1)} by {m.group(3)}", text)
    text = re.sub(_number_re, _number_sub, text)
    return text


def normalize_currency(text: str) -> str:
    return re.sub(_currency_re, _currency_sub, text)


# ---------------------------------------------------------------------------
# abbreviations (abbreviations.py:22-74)
# ---------------------------------------------------------------------------
_ABBREV = [(re.compile(r"\b%s\." % pat, re.IGNORECASE), rep) for pat, rep in [
    ("mrs", "misess"), ("ms", "miss"), ("mr", "mister"), ("dr", "doctor"),
    ("st", "saint"), ("co", "company"), ("jr", "junior"), ("maj", "major"),
    ("gen", "general"), ("drs", "doctors"), ("rev", "reverend"),
    ("lt", "lieutenant"), ("hon", "honorable"), ("sgt", "sergeant"),
    ("capt", "captain"), ("esq", "esquire"), ("ltd", "limited"),
    ("col", "colonel"), ("ft", "fort"),
]]
_no_period_re = re.compile(r"(No[.])(?=[ ]?[0-9])")
_percent_re = re.compile(r"([ ]?[%])")
_half_re = re.compile(r"([0-9]½)|(½)")


def normalize_abbreviations(text: str) -> str:
    text = re.sub(_no_period_re,
                  lambda m: "Number" if m.group(0)[0] == "N" else "number",
                  text)
    text = re.sub(_percent_re, " percent", text)
    text = re.sub(_half_re,
                  lambda m: "half" if m.group(1) is None
                  else m.group(1)[0] + " and a half", text)
    for rx, rep in _ABBREV:
        text = rx.sub(rep, text)
    return text


# ---------------------------------------------------------------------------
# dates / times (datestime.py:25-45)
# ---------------------------------------------------------------------------
_ampm_re = re.compile(
    r"([0-9]|0[0-9]|1[0-9]|2[0-3]):?([0-5][0-9])?\s*([AaPp][Mm]\b)")


def normalize_datestime(text: str) -> str:
    def sub(m):
        hour, minute, half = m.groups(0)
        out = hour if (not minute or int(minute) == 0) else \
            hour + " " + minute
        return out + (" a.m." if half[0].lower() == "a" else " p.m.")
    return re.sub(_ampm_re, sub, text)


# ---------------------------------------------------------------------------
# letters + numbers (letters_and_numbers.py:24-112)
# ---------------------------------------------------------------------------
_letters_numbers_re = re.compile(
    r"((?:[a-zA-Z]+[0-9]|[0-9]+[a-zA-Z])[a-zA-Z0-9']*)", re.IGNORECASE)
_hardware_re = re.compile(
    r"([0-9]+(?:[.,][0-9]+)?)(?:\s?)(tb|gb|mb|kb|ghz|mhz|khz|hz|mm)",
    re.IGNORECASE)
_HARDWARE_KEY = {"tb": "terabyte", "gb": "gigabyte", "mb": "megabyte",
                 "kb": "kilobyte", "ghz": "gigahertz", "mhz": "megahertz",
                 "khz": "kilohertz", "hz": "hertz", "mm": "millimeter",
                 "cm": "centimeter", "km": "kilometer"}
_dimension_re = re.compile(
    r"\b(\d+(?:[,.]\d+)?\s*[xX]\s*\d+(?:[,.]\d+)?\s*[xX]\s*\d+"
    r"(?:[,.]\d+)?(?:in|inch|m)?)\b"
    r"|\b(\d+(?:[,.]\d+)?\s*[xX]\s*\d+(?:[,.]\d+)?(?:in|inch|m)?)\b")


def _letters_numbers_sub(m: re.Match) -> str:
    parts = [p for p in re.split(r"(\d+)", m.group(0))]
    if parts and parts[-1] == "":
        parts = parts[:-1]
    if parts and parts[0] == "":
        parts = parts[1:]
    if (len(parts) >= 2 and parts[-1] in ("'s", "s", "th", "nd", "st", "rd")
            and parts[-2].isdigit()):
        parts[-2] = parts[-2] + parts[-1]
        parts = parts[:-1]
    out = []
    for s in parts:
        if s.isdigit() and len(s) < 5:
            if len(s) > 2 and s[-2] == "0":
                group = [s] if s[-1] == "0" else [s[:-3], s[-2], s[-1]]
                group = [g for g in group if g]
            elif len(s) % 2 == 0:
                group = [s[i:i + 2] for i in range(0, len(s), 2)]
            elif len(s) > 2:
                group = [s[0]] + [s[i:i + 2] for i in range(1, len(s), 2)]
            else:
                group = [s]
            out.extend(group)
        else:
            out.append(s)
    return " ".join(out)


def normalize_letters_and_numbers(text: str) -> str:
    text = re.sub(_hardware_re,
                  lambda m: "{} {}".format(
                      m.group(1), _HARDWARE_KEY[m.group(2).lower()]), text)
    text = re.sub(_dimension_re, lambda m: re.sub(r"[xX]", " by ",
                                                  m.group(0)), text)
    text = re.sub(_letters_numbers_re, _letters_numbers_sub, text)
    return text


# ---------------------------------------------------------------------------
# ASCII transliteration (the cleaner's unidecode call) — covers the accented
# Latin ranges present in the radmmm symbol set.
# ---------------------------------------------------------------------------
_TRANSLIT = {
    "à": "a", "á": "a", "â": "a", "ã": "a", "ä": "a", "å": "a", "æ": "ae",
    "ç": "c", "ć": "c", "è": "e", "é": "e", "ê": "e", "ë": "e", "ì": "i",
    "í": "i", "î": "i", "ï": "i", "ñ": "n", "ò": "o", "ó": "o", "ô": "o",
    "õ": "o", "ö": "o", "ø": "o", "œ": "oe", "ù": "u", "ú": "u", "û": "u",
    "ü": "u", "ý": "y", "ÿ": "y", "ž": "z", "ß": "ss", "—": "-", "–": "-",
    "‘": "'", "’": "'", "“": '"', "”": '"', "½": " half ", "°": " degrees ",
    "©": "", "€": "euro", "£": "pound", "₩": "won",
}
_TRANSLIT.update({k.upper(): v.upper() for k, v in list(_TRANSLIT.items())
                  if k.isalpha()})


def to_ascii(text: str) -> str:
    out = []
    for ch in text:
        if ord(ch) < 128:
            out.append(ch)
        else:
            out.append(_TRANSLIT.get(ch, _TRANSLIT.get(ch.lower(), "")))
    return "".join(out)
