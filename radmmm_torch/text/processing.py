"""TextProcessing: clean -> G2P -> tokenize pipeline.

Equivalent of tts_text_processing/text_processing.py:72-374:
* curly-brace {...} spans are treated as space-separated phoneme tokens;
* per-language phonemizer dictionaries (word -> IPA) with heteronym and
  ambiguity handling and possessive/'s fallbacks;
* marker/diacritic/diphthong-aware greedy parsing of IPA strings into the
  symbol inventory (parse_phonemized_text);
* optional prepended/appended space and <bos>/<eos> tokens.

The recursive reference parser is re-written iteratively (Python recursion
on 1k-char strings is a stack hazard, and this path runs per utterance in
the data pipeline).
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np

from radmmm_torch.text.cleaners import Cleaner
from radmmm_torch.text.dictionary import Grapheme2PhonemeDictionary
from radmmm_torch.text.symbols import get_symbols, PHONEMIZER_DIACRITICS

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")
_words_re = re.compile(
    r"([a-zA-Zऀ-ॿ]+['][a-zA-Zऀ-ॿ]+"
    r"|[a-zA-Zऀ-ॿ]+)|([{][^}]+[}]|[^a-zA-Zऀ-ॿ{}]+)")

PHONEMIZER_LANGUAGE_MAP = {
    "hi_HI": "hi", "hi": "hi", "mar_MAR": "mr", "te_TE": "te",
    "pt_BR": "pt-br", "en_US": "en-us", "en": "en-us", "de_DE": "de",
    "fr_FR": "fr-fr", "es_ES": "es", "es_CO": "es-419", "es_AR": "es-419",
    "es_CL": "es-419", "es_PE": "es-419", "es_PR": "es-419",
    "es_VE": "es-419", "es_MX": "es-419", "en_ES": "en-us",
    "en_MN": "en-us", "en_UK": "en-gb",
}


def _lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [ln.rstrip() for ln in f]


class TextProcessing:
    def __init__(self, symbol_set: str, cleaner_name, heteronyms_path=None,
                 phoneme_dict_path=None, p_phoneme: float = 1.0,
                 handle_phoneme: str = "word",
                 handle_phoneme_ambiguous: str = "ignore",
                 prepend_space_to_text: bool = False,
                 append_space_to_text: bool = False,
                 add_bos_eos_to_text: bool = False,
                 encoding: str = "latin-1", dict_split_token: str = "\t",
                 external_symbol_set_path: Optional[str] = None,
                 g2p_type: str = "phonemizer",
                 phonemizer_cfg: Optional[Dict[str, str]] = None,
                 rng: Optional[np.random.Generator] = None):
        self.g2p_type = g2p_type
        self.rng = rng or np.random.default_rng(1234)
        self.heteronyms = (set(_lines(heteronyms_path))
                           if heteronyms_path and os.path.exists(
                               heteronyms_path) else set())

        # Missing dictionary assets degrade gracefully (warn + raw-text
        # passthrough) instead of crashing at construction — the reference
        # hits a bare pdb.set_trace() here (data.py:206-211); phonemizerless
        # recipes never consult these dicts at all.
        self.phonemedict = None
        self.phonemizer_backend_dict: Dict[str, Grapheme2PhonemeDictionary] = {}
        if g2p_type == "phonemizer":
            for language, path in (phonemizer_cfg or {}).items():
                if not os.path.exists(path):
                    print(f"TextProcessing: phonemizer dict for {language} "
                          f"not found at {path}; G2P disabled for it")
                    continue
                self.phonemizer_backend_dict[language] = \
                    Grapheme2PhonemeDictionary(
                        path, encoding=encoding, split_token=dict_split_token,
                        language=language)
        elif phoneme_dict_path:
            if os.path.exists(phoneme_dict_path):
                self.phonemedict = Grapheme2PhonemeDictionary(
                    phoneme_dict_path, encoding=encoding,
                    split_token=dict_split_token)
            else:
                print(f"TextProcessing: phoneme dict not found at "
                      f"{phoneme_dict_path}; G2P disabled")

        self.cleaner = Cleaner(cleaner_name, self.phonemedict)
        self.p_phoneme = p_phoneme
        self.handle_phoneme = handle_phoneme
        self.handle_phoneme_ambiguous = handle_phoneme_ambiguous

        (self.symbols, self.markers, self.placeholder_set,
         self.diphthongs_set) = get_symbols(symbol_set,
                                            external_symbol_set_path)
        self.prepend_space_to_text = prepend_space_to_text
        self.append_space_to_text = append_space_to_text
        self.add_bos_eos_to_text = add_bos_eos_to_text
        if add_bos_eos_to_text:
            self.symbols = list(self.symbols) + ["<bos>", "<eos>"]

        self.symbol_to_id = {s: i for i, s in enumerate(self.symbols)}
        self.id_to_symbol = {i: s for i, s in enumerate(self.symbols)}

    # ---- tokenization -----------------------------------------------------
    def parse_phonemized_text(self, text: str) -> List[str]:
        """Greedy split of an IPA string into marker-bound tokens."""
        ph = self.placeholder_set
        out: List[str] = []
        while text:
            head = text[0]
            if ph and head in ph["right"]:
                if len(text) > 1:
                    out.append(head + text[1])
                    text = text[2:]
                else:
                    out.append(head)
                    text = text[1:]
            elif ph and head in ph["other"]:
                out.append(head)
                text = text[1:]
            elif ph and len(text) > 1 and text[1] in ph["left"]:
                out.append(head + text[1])
                text = text[2:]
            elif len(text) > 1:
                token, rest = head, text[1:]
                if self.diphthongs_set:
                    for i in range(len(text)):
                        if text[:i + 1] in self.diphthongs_set:
                            token, rest = text[:i + 1], text[i + 1:]
                out.append(token)
                text = rest
            else:
                out.append(head)
                text = ""
        return out

    def symbols_to_sequence(self, symbols) -> List[int]:
        seq: List[int] = []
        for s in symbols:
            if s in self.symbol_to_id:
                seq.append(self.symbol_to_id[s])
                continue
            if self.placeholder_set is None:
                for ch in symbols:
                    if ch != "@" and "@" + ch in self.symbol_to_id:
                        seq.append(self.symbol_to_id["@" + ch])
                continue
            for token in self.parse_phonemized_text(s):
                if token == "@":
                    continue
                if "@" + token in self.symbol_to_id:
                    seq.append(self.symbol_to_id["@" + token])
                else:
                    for ch in token:
                        if ch != "@" and "@" + ch in self.symbol_to_id:
                            seq.append(self.symbol_to_id["@" + ch])
        return seq

    def phoneme_to_sequence(self, text: str) -> List[int]:
        return self.symbols_to_sequence(["@" + s for s in text.split()])

    def text_to_sequence(self, text: str) -> List[int]:
        seq: List[int] = []
        while len(text):
            m = _curly_re.match(text)
            if not m:
                seq += self.symbols_to_sequence(text)
                break
            seq += self.symbols_to_sequence(m.group(1))
            seq += self.phoneme_to_sequence(m.group(2))
            text = m.group(3)
        return seq

    def sequence_to_text(self, sequence) -> str:
        out = ""
        for sid in sequence:
            s = self.id_to_symbol.get(int(sid))
            if s is None:
                continue
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            out += s
        return out.replace("}{", " ")

    # ---- G2P --------------------------------------------------------------
    def _pick_pronunciation(self, prons):
        if isinstance(prons, list) and len(prons) > 1:
            if self.handle_phoneme_ambiguous == "first":
                return prons[0]
            if self.handle_phoneme_ambiguous == "random":
                return self.rng.choice(prons)
            if self.handle_phoneme_ambiguous == "ignore":
                return None
            return prons[0]
        return prons[0] if isinstance(prons, list) else prons

    def get_phoneme(self, word: str, phoneme_dict=None) -> str:
        suffix = ""
        if phoneme_dict is not None:
            prons = phoneme_dict.lookup(word)
            if prons is None:
                return word
            pron = self._pick_pronunciation(prons)
            if pron is None:
                return word
            return "{" + "".join(pron) + "}"

        phoneme_dict = self.phonemedict
        if phoneme_dict is None or word.lower() in self.heteronyms:
            return word
        prons = phoneme_dict.lookup(word)
        if prons is None and len(word) > 2 and word.endswith("'s"):
            prons = phoneme_dict.lookup(word[:-2])
            suffix = "" if prons is None else " Z"
        elif prons is None and len(word) > 1 and word.endswith("s"):
            prons = phoneme_dict.lookup(word[:-1])
            suffix = "" if prons is None else " Z"
        if prons is None:
            return word
        pron = self._pick_pronunciation(prons)
        if pron is None:
            return word
        return "{" + pron + suffix + "}"

    def convert_to_phoneme(self, text: str, phoneme_dict=None) -> str:
        if self.handle_phoneme == "sentence":
            if self.rng.uniform() < self.p_phoneme:
                words = _words_re.findall(text)
                parts = [self.get_phoneme(w[0], phoneme_dict=phoneme_dict)
                         if w[0] != "" else re.sub(r"\s(\d)", r"\1", w[1])
                         for w in words]
                text = "".join(parts)
        elif self.handle_phoneme == "word":
            words = _words_re.findall(text)
            parts = [
                re.sub(r"\s(\d)", r"\1", w[1]) if w[0] == "" else (
                    self.get_phoneme(w[0], phoneme_dict=phoneme_dict)
                    if self.rng.uniform() < self.p_phoneme else w[0])
                for w in words]
            # merge stray diacritic tokens into their neighbors
            if len(parts) > 1 and parts[-1] in PHONEMIZER_DIACRITICS:
                parts[-2] = parts[-2][:-1] + parts[-1] + parts[-2][-1:]
                del parts[-1]
            if len(parts) > 1 and parts[0] in PHONEMIZER_DIACRITICS:
                parts[1] = parts[1][:1] + parts[0] + parts[1][1:]
                del parts[0]
            text = "".join(parts)
        elif self.handle_phoneme != "":
            raise ValueError(
                f"{self.handle_phoneme} handle_phoneme is not supported")
        return text

    # ---- public API -------------------------------------------------------
    def clean_text(self, text: str) -> str:
        return self.cleaner(text)

    def encode_text(self, text: str, return_all: bool = False,
                    language: Optional[str] = None,
                    is_phonemized: bool = False):
        text_clean, text_phoneme = "", ""
        if not is_phonemized:
            text_clean = self.clean_text(text)
            text = text_clean
            if self.g2p_type == "custom":
                if self.p_phoneme > 0:
                    text_phoneme = self.convert_to_phoneme(text)
                    text = text_phoneme
                encoded = self.text_to_sequence(text)
            elif self.g2p_type == "phonemizer":
                assert language is not None, \
                    "phonemizer G2P needs the utterance language"
                backend = self.phonemizer_backend_dict[language]
                text_phoneme = self.convert_to_phoneme(
                    text, phoneme_dict=backend)
                encoded = self.text_to_sequence(text_phoneme)
            else:
                encoded = self.text_to_sequence(text)
        else:
            text_phoneme = text
            encoded = self.text_to_sequence(text_phoneme)

        if self.prepend_space_to_text:
            encoded.insert(0, self.symbol_to_id[" "])
        if self.append_space_to_text:
            encoded.append(self.symbol_to_id[" "])
        if self.add_bos_eos_to_text:
            encoded.insert(0, self.symbol_to_id["<bos>"])
            encoded.append(self.symbol_to_id["<eos>"])

        if return_all:
            return encoded, text_clean, text_phoneme
        return encoded
