"""Grapheme-to-phoneme dictionaries (TSV word->IPA, CMUdict format).

Equivalent of tts_text_processing/grapheme_dictionary.py:27-86 and
cmudict.py: per-language lookup tables with multi-pronunciation
(heteronym/ambiguity) support.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

_cmu_alt_re = re.compile(r"\([0-9]+\)")


class Grapheme2PhonemeDictionary:
    """word -> list of pronunciations, loaded from 'word<sep>phones' lines."""

    def __init__(self, file_or_path, keep_ambiguous: bool = True,
                 encoding: str = "latin-1", split_token: str = "\t",
                 language: Optional[str] = None):
        self.language = language
        entries: Dict[str, List[str]] = {}
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding=encoding) as f:
                entries = self._parse(f, split_token)
        else:
            entries = self._parse(file_or_path, split_token)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self.dict = entries

    @staticmethod
    def _parse(lines, split_token) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for line in lines:
            line = line.rstrip("\n")
            if not line or line.startswith(";;;"):
                continue
            if split_token in line:
                word, phones = line.split(split_token, 1)
            else:
                parts = line.split(None, 1)
                if len(parts) != 2:
                    continue
                word, phones = parts
            word = _cmu_alt_re.sub("", word).lower()
            out.setdefault(word, []).append(phones.strip())
        return out

    def lookup(self, word: str) -> Optional[List[str]]:
        return self.dict.get(word.lower())

    def __len__(self):
        return len(self.dict)
