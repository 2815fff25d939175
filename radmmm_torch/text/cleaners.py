"""Cleaner pipelines: sequence-level then word-level normalizers.

Equivalent of tts_text_processing/cleaners.py:98-135: named pipelines
(basic / english / radtts / transliteration) of sequence functions applied
to the whole string and word functions applied per whitespace token, with
{phoneme} spans passed through untouched.
"""
from __future__ import annotations

import re
from functools import reduce
from string import punctuation

from radmmm_torch.text.norm import (normalize_numbers, normalize_currency,
                                  normalize_datestime,
                                  normalize_letters_and_numbers,
                                  normalize_abbreviations, to_ascii)

_whitespace_re = re.compile(r"\s+")
_arpa_re = re.compile(r"{[^}]+}|\S+")


def lowercase(text):
    return text.lower()


def collapse_whitespace(text):
    return re.sub(_whitespace_re, " ", text)


def separate_acronyms(text):
    text = re.sub(r"([0-9]+)([a-zA-Z]+)", r"\1 \2", text)
    return re.sub(r"([a-zA-Z]+)([0-9]+)", r"\1 \2", text)


def dehyphenize_compound_words(text):
    return re.sub(r"(?<=[a-zA-Z0-9])-(?=[a-zA-Z])", " ", text)


def remove_space_before_punctuation(text):
    return re.sub(r"\s([{}](?:\s|$))".format(punctuation), r"\1", text)


_PIPELINES = {
    "basic_cleaners": ([lowercase, collapse_whitespace], []),
    "english_cleaners": ([collapse_whitespace, to_ascii, lowercase],
                         [normalize_numbers, normalize_abbreviations]),
    "radtts_cleaners": ([collapse_whitespace, normalize_currency,
                         normalize_datestime, normalize_letters_and_numbers],
                        [normalize_numbers, normalize_abbreviations]),
    "transliteration_cleaners": ([to_ascii, lowercase, collapse_whitespace],
                                 []),
}


class Cleaner:
    def __init__(self, cleaner_names, phoneme_dict=None):
        if isinstance(cleaner_names, str):
            cleaner_names = [cleaner_names]
        self.cleaner_names = cleaner_names
        for name in cleaner_names:
            if name not in _PIPELINES:
                raise ValueError(f"{name} cleaner not supported")

    def __call__(self, text: str) -> str:
        for name in self.cleaner_names:
            sequence_fns, word_fns = _PIPELINES[name]
            for fn in sequence_fns:
                text = fn(text)
            pieces = [
                reduce(lambda acc, fn: fn(acc), word_fns, tok)
                if not tok.startswith("{") else tok
                for tok in _arpa_re.findall(text)
            ]
            text = " ".join(pieces)
        return remove_space_before_punctuation(text)
