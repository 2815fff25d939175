"""Acronym expansion: spell out all-caps tokens as letter phonemes.

Equivalent of tts_text_processing/acronyms.py:24-88 — dictionary lookup
first, otherwise per-letter ARPAbet spelling with the trailing plural 's'
merged into the last letter's phonemes.
"""
from __future__ import annotations

import re
from typing import Optional

LETTER_ARPABET = {
    "A": "EY1", "B": "B IY1", "C": "S IY1", "D": "D IY1", "E": "IY1",
    "F": "EH1 F", "G": "JH IY1", "H": "EY1 CH", "I": "AY1", "J": "JH EY1",
    "K": "K EY1", "L": "EH1 L", "M": "EH1 M", "N": "EH1 N", "O": "OW1",
    "P": "P IY1", "Q": "K Y UW1", "R": "AA1 R", "S": "EH1 S", "T": "T IY1",
    "U": "Y UW1", "V": "V IY1", "X": "EH1 K S", "Y": "W AY1",
    "W": "D AH1 B AH0 L Y UW0", "Z": "Z IY1", "s": "Z",
}

_acronym_re = re.compile(r"([A-Z][A-Z]+)s?")


class AcronymNormalizer:
    def __init__(self, phoneme_dict=None):
        self.phoneme_dict = phoneme_dict

    def __call__(self, text: str) -> str:
        def expand(m: re.Match) -> str:
            acronym = re.sub(r"\.", "", m.group(0)).replace(" ", "")
            prons = (self.phoneme_dict.lookup(acronym)
                     if self.phoneme_dict else None)
            if prons is None:
                spelled = ["{" + LETTER_ARPABET[ch] + "}" for ch in acronym
                           if ch in LETTER_ARPABET]
                if len(spelled) > 1 and spelled[-1] == "{Z}":
                    spelled[-2] = spelled[-2][:-1] + " " + spelled[-1][1:]
                    del spelled[-1]
                return " ".join(spelled)
            if len(prons) == 1:
                return "{" + prons[0] + "}"
            return acronym
        return _acronym_re.sub(expand, text)
