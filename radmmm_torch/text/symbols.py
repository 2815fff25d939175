"""Symbol inventories and tokenizer symbol-set construction.

Equivalent of tts_text_processing/symbols.py:188-402 — the same named
symbol sets ('english_basic', 'radtts', 'radmmm',
'radmmm_phonemizer_exhaustive', 'radmmm_phonemizer_marker_segregated'),
built from the published IPA chart inventory (en.wikipedia.org IPA chart)
and espeak-ng marker conventions. Placeholder markers ('◌' anchors) encode
whether a diacritic binds to the left, right, or stands alone.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

ARPABET = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0",
    "AH1", "AH2", "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2",
    "AY", "AY0", "AY1", "AY2", "B", "CH", "D", "DH", "EH", "EH0", "EH1",
    "EH2", "ER", "ER0", "ER1", "ER2", "EY", "EY0", "EY1", "EY2", "F", "G",
    "HH", "IH", "IH0", "IH1", "IH2", "IY", "IY0", "IY1", "IY2", "JH", "K",
    "L", "M", "N", "NG", "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1",
    "OY2", "P", "R", "S", "SH", "T", "TH", "UH", "UH0", "UH1", "UH2", "UW",
    "UW0", "UW1", "UW2", "V", "W", "Y", "Z", "ZH",
]

IPA_BASIC = [
    "aɪ", "aʊ", "b", "d", "dʒ", "e", "eɪ", "f", "g", "h", "i", "j", "k",
    "l", "m", "n", "oʊ", "p", "r", "s", "t", "tʃ", "u", "v", "w", "z", "æ",
    "ð", "ŋ", "ɑ", "ɔ", "ɔɪ", "ə", "ər", "ɜr", "ɪ", "ʃ", "ʊ", "ʌ", "ʒ",
    "θ",
]

# espeak-ng phoneme marker conventions (docs/phonemes.md); the '◌' anchor
# marks which side the diacritic binds to.
ESPEAK_MARKERS: Dict[str, List[str]] = {
    "stress": ["ˈ", "ˌ"],
    "length_placeholder_left": ["◌̆", "◌ˑ", "◌ː", "◌ːː"],
    "rhythm": [".", "◌‿◌"],
    "tones_placeholder_left": ["◌˥", "◌˦", "◌˧", "◌˨", "◌˩", "ꜛ◌", "ꜜ◌"],
    "tones_placeholder_right": ["ꜛ◌", "ꜜ◌"],
    "intonation": ["`", "‖", "↗︎", "↘︎"],
    "fortis_placeholder_left": ["◌͈"],
    "lenis_placeholder_left": ["◌͉"],
    "lesser_oral_pressure_placeholder_left": ["◌͈"],
    "greater_oral_pressure_placeholder_left": ["◌͉"],
    "articulation_placeholder_left": ["◌ʲ", "◌ˠ", "◌̴", "◌ˤ", "◌̴", "◌̃",
                                      "◌˞"],
}

PHONEMIZER_DIACRITICS = ["!", "[", ";", "^", "<H>", "<h>", "<o>", "<r>",
                         "<w>", "<?>", "~", "-", ".", '"', "`"]

PHONEMIZER_EXTRA = ["ɚ", "ɝ", "R", "R<umd>", "¿", "¡", "ᵻ", "!", '"', ";",
                    "ɚ", "ɟ"]

NUMBERS = "0123456789"
MATH = "#%&*+-/[]()"
SPECIAL = "_@©°½—₩€$"

# IPA chart inventory (pulmonic + non-pulmonic + co-articulated consonants,
# vowels, common diphthongs)
IPA_CONSONANTS = [
    "m̥", "m", "ɱ", "n̼", "n̥", "n", "ɳ̊", "ɳ", "ɲ̊", "ɲ", "ŋ̊", "ŋ", "ɴ",
    "p", "b", "p̪", "b̪", "t̼", "d̼", "t", "d", "ʈ", "ɖ", "c", "ɟ", "k",
    "ɡ", "q", "ɢ", "ʡ", "ʔ",
    "ts", "dz", "t̠ʃ", "d̠ʒ", "tʂ", "dʐ", "tɕ", "dʑ",
    "pɸ", "bβ", "p̪f", "b̪v", "t̪θ", "d̪ð", "tɹ̝̊", "dɹ̝", "t̠ɹ̠̊˔",
    "d̠ɹ̠˔", "cç", "ɟʝ", "kx", "ɡɣ", "qχ", "ɢʁ", "ʡʜ", "ʡʢ", "ʔh",
    "s", "z", "ʃ", "ʒ", "ʂ", "ʐ", "ɕ", "ʑ",
    "ɸ", "β", "f", "v", "θ̼", "ð̼", "θ", "ð", "θ̠", "ð̠", "ɹ̠̊˔", "ɹ̠˔",
    "ɻ̊˔", "ɻ˔", "ç", "ʝ", "x", "ɣ", "χ", "ʁ", "ħ", "ʕ", "h", "ɦ",
    "ʋ", "ɹ", "ɻ", "j", "ɰ", "ʔ̞",
    "ⱱ̟", "ⱱ", "ɾ̼", "ɾ̥", "ɾ", "ɽ̊", "ɽ", "ɡ̆", "ɢ̆", "ʡ̆",
    "ʙ̥", "ʙ", "r̥", "r", "ɽ̊r̥", "ɽr", "ʀ̥", "ʀ", "ʜ", "ʢ",
    "tɬ", "dɮ", "tɭ̊˔", "dɭ˔", "cʎ̝̊", "ɟʎ̝", "kʟ̝̊", "ɡʟ̝",
    "ɬ", "ɮ", "ꞎ", "ɭ˔", "𝼆", "ʎ̝", "𝼄", "ʟ̝",
    "l", "ɭ", "ʎ", "ʟ", "ʟ̠",
    "ɺ̥", "ɺ", "𝼈̥", "𝼈", "ʎ̆", "ʟ̆",
    "t̪θʼ", "tsʼ", "t̠ʃʼ", "tʂʼ", "kxʼ", "qχʼ",
    "ɸʼ", "fʼ", "θʼ", "sʼ", "ʃʼ", "ʂʼ", "ɕʼ", "xʼ", "χʼ",
    "tɬʼ", "c𝼆ʼ", "k𝼄ʼ", "ɬʼ",
    "kʘ", "qʘ", "kǀ", "qǀ", "kǃ", "qǃ", "k𝼊", "q𝼊", "kǂ", "qǂ",
    "ɡʘ", "ɢʘ", "ɡǀ", "ɢǀ", "ɡǃ", "ɢǃ", "", "ɡ𝼊, ɢ𝼊", "ɡǂ", "ɢǂ",
    "ŋʘ", "ɴʘ", "ŋǀ", "ɴǀ", "ŋǃ", "ɴǃ", "ŋ𝼊", "ɴ𝼊", "ŋǂ", "ɴǂ", "ʞ",
    "kǁ", "qǁ", "ɡǁ", "ɢǁ", "ŋǁ", "ɴǁ",
    "ɓ", "ɗ", "ᶑ", "ʄ", "ɠ", "ʛ", "ɓ̥", "ɗ̥", "ᶑ̊", "ʄ̊", "ɠ̊", "ʛ̥",
    "n͡m", "ŋ͡m", "ɥ̊", "ɥ", "ʍ", "w",
    "ɧ", "t͡p", "d͡b", "k͡p", "ɡ͡b", "q͡ʡ", "ɫ",
]

IPA_VOWELS = [
    "i", "y", "ɨ", "ʉ", "ɯ", "u", "ɪ", "ʏ", "ʊ", "e", "ø", "ɘ", "ɵ", "ɤ",
    "o", "e̞", "ø̞", "ə", "ɤ̞", "o̞", "œ", "ɜ", "ɞ", "ʌ", "ɔ", "ɛ", "ɐ",
    "æ", "a", "ɶ", "ä", "ɑ", "ɒ",
]

DIPHTHONGS = ["eɪ", "oʊ", "aʊ", "ɪə", "eə", "ɔɪ", "aɪ", "ʊə", "dʒ"]

IPA_MARKERS: Dict[str, List[str]] = {
    "tones_placeholder_left": ["◌̋", "◌˥", "◌́", "◌˦", "◌̏", "◌˩", "◌̌"],
    "tones_placeholder_right": ["꜓◌", "꜒◌", "꜕◌", "ꜜ◌", "ꜛ◌", "꜖◌"],
    "aux_symbols_placeholder_left": [
        "◌̥", "◌̊", "◌̤", "◌̪", "◌͆", "◌̬", "◌̰", "◌̺", "◌ʰ", "◌̼", "◌̻",
        "◌̹", "◌͗", "◌˒", "◌ʷ", "◌̃", "◌̜", "◌͑", "◌˓", "◌ʲ", "◌ⁿ", "◌̟",
        "◌˖", "◌ˠ", "◌ˡ", "◌̠", "◌˗", "◌ˤ", "◌̚", "◌̈", "◌̴", "◌ᵊ", "◌̽",
        "◌˔", "◌ᶿ", "◌̩", "◌̍", "◌̞", "◌˕", "◌ˣ", "◌̯", "◌̑", "◌̘", "◌꭪",
        "◌ʼ", "◌˞", "◌̙", "◌꭫", "◌͡◌", "◌͜◌"],
    "suprasegmentals": ["ˈ", "ˌ", "ː", "ˑ", "◌̆", "|", "‖", ".", "‿",
                        "↗︎", "↘︎"],
}

PUNCTUATION = "“”\\{\\}-!'\"(),.:;? " + "，。？！；：、''""（）【】「」《》"


def _collect_markers(tables: List[Dict[str, List[str]]]):
    """Split marker tables into bare markers + left/right/other placeholders.

    Inventory-parity quirk: the reference builds the wiki table's
    non-placeholder buckets from a *stale* loop variable left over from the
    espeak table (symbols.py:302-305 / 363-366 reuse `markers_list` inside
    the wiki loop), so the wiki 'suprasegmentals' contribute the espeak
    articulation entries (anchors and all) instead of themselves. The
    shipped 426-token production set was built this way, so we reproduce it
    for tables after the first.
    """
    placeholder = {"left": [], "right": [], "other": []}
    markers: List[str] = []
    stale_entries: List[str] = []
    for table_index, table in enumerate(tables):
        for key, entries in table.items():
            if "placeholder_left" in key:
                bare = [m[1:] for m in entries]   # strip leading anchor
                placeholder["left"] += bare
            elif "placeholder_right" in key:
                bare = [m[0] for m in entries]    # keep marker before anchor
                placeholder["right"] += bare
            else:
                bare = stale_entries if table_index > 0 else entries
                placeholder["other"] += bare
            markers += bare
            if table_index == 0:
                stale_entries = entries
    return sorted(set(markers)), {k: sorted(set(v))
                                  for k, v in placeholder.items()}


def _radmmm_charset() -> List[str]:
    punctuation = "¡!'\"\",.:;¿?-/ "
    accented_upper = "ÀÈÌÒÙÁÉÍÓÚĆÂÊÎÔÛÄËÏÖÜÃÕÑÆŒÇØŽÅŸÝ"
    accented_lower = "àèìòùáéíóúćâêîôûäëïöüãõñæœçøžåÿýj̃ũẽ"
    hi_accents = ["॑", "॒", "॓", "॔", "ॕ"]
    letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
    ipa_from_dicts = [
        "'", "(", ")", ",", ".", ":", "?", "A", "C", "D", "E", "F", "N",
        "O", "Q", "R", "S", "T", "U", "Z", "a", "b", "c", "d", "e", "f",
        "g", "h", "i", "j", "k", "l", "m", "n", "o", "p", "r", "s", "t",
        "u", "v", "w", "x", "y", "z", "|", "ã", "æ", "ç", "ð", "õ", "ø",
        "ĭ", "ŋ", "œ", "ɐ", "ɑ", "ɒ", "ɔ", "ɕ", "ɘ", "ə", "ɛ", "ɜ", "ɝ",
        "ɡ", "ɣ", "ɥ", "ɪ", "ɫ", "ɬ", "ɱ", "ɲ", "ɹ", "ɽ", "ɾ", "ʀ", "ʁ",
        "ʃ", "ʊ", "ʋ", "ʌ", "ʎ", "ʏ", "ʒ", "ʔ", "ʝ", "ʧ", "ʰ", "ʲ", "ʼ",
        "ˀ", "ˈ", "ˌ", "ː", "ˑ", "̃", "̆", "̍", "̥", "̩", "̯", "͜", "͡",
        "β", "ε", "θ", "χ", "ᵻ", "ãː", "ऑ", "औ", "ऍ"]
    hi_punct = ["॥", "।", "//", "\\/"]
    hi_vowels = ["ə", "a", "aː", "i", "iː", "u", "uː", "e", "æː", "o", "ɔ",
                 "ɔː", "r̩"]
    hi_consonants = [
        "k", "kʰ", "ɡ", "ɡ̤", "ŋ", "t͡ʃ", "t͡ʃʰ", "d͡ʒ", "d͡ʒ̤", "ɲ", "ʈ",
        "ʈʰ", "ɖ", "ɖ̤", "ɳ", "t", "tʰ", "d", "d̤", "n", "p", "pʰ", "b",
        "b̤", "m", "j", "r", "l", "v", "ʃ", "ʂ", "s", "ɦ", "q", "x", "ɣ",
        "z", "ʒ", "f", "ɽ", "ɽ̤", "ɽ̥"]
    pt_symbols = ["ɐ̃", "w̃", "kʷ", "ɡʷ", "-", "ũː", "ə̃", "æ̃ː"]
    symbols = list(punctuation + MATH + SPECIAL + accented_lower
                   + accented_upper + "ß" + NUMBERS + letters)
    symbols += ["@" + s for s in hi_vowels + hi_consonants + pt_symbols]
    symbols += hi_punct + hi_accents
    symbols += ["@" + s for s in IPA_BASIC + ipa_from_dicts]
    return sorted(set(symbols))


def get_symbols(symbol_set: str,
                external_symbol_set_path: Optional[str] = None):
    """-> (symbols, markers, placeholder_set, diphthongs_set)."""
    markers = None
    placeholder_set = None
    diphthongs = None

    if symbol_set in ("english_basic", "english_basic_lowercase"):
        letters = ("abcdefghijklmnopqrstuvwxyz"
                   if symbol_set.endswith("lowercase") else
                   "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz")
        symbols = list("_-" + "!'\"(),.:;? " + letters) \
            + ["@" + s for s in ARPABET]
    elif symbol_set == "english_expanded":
        symbols = list("!'\",.:;? " + MATH + SPECIAL + "áçéêëñöøćž"
                       + "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                       "abcdefghijklmnopqrstuvwxyz") \
            + ["@" + s for s in ARPABET]
    elif symbol_set == "radtts":
        symbols = list("!'\",.:;? " + MATH + SPECIAL + "áçéêëñöøćž"
                       + NUMBERS + "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                       "abcdefghijklmnopqrstuvwxyz") \
            + ["@" + s for s in ARPABET]
    elif symbol_set == "radmmm":
        symbols = _radmmm_charset()
        if external_symbol_set_path:
            with open(external_symbol_set_path) as f:
                extra = [ln.rstrip() for ln in f if ln.rstrip()]
            symbols = sorted(set(symbols) | set(extra))
    elif symbol_set in ("radmmm_phonemizer_exhaustive",
                        "radmmm_phonemizer_marker_segregated"):
        markers, placeholder_set = _collect_markers(
            [ESPEAK_MARKERS, IPA_MARKERS])
        base = sorted(set(IPA_CONSONANTS + IPA_VOWELS + PHONEMIZER_EXTRA
                          + DIPHTHONGS + list(SPECIAL) + list(MATH)))
        diphthongs = sorted({s for s in base if len(s) > 1})
        if symbol_set == "radmmm_phonemizer_exhaustive":
            crossed = []
            for sym in base:
                for m in placeholder_set["left"]:
                    crossed.append(sym + m)
                for m in placeholder_set["right"]:
                    crossed.append(m + sym)
            crossed += placeholder_set["other"] + base
            phon = sorted(set(crossed)) + list(PUNCTUATION) + list(NUMBERS) \
                + list(MATH)
            symbols = sorted(set(["@" + s for s in phon]
                                 + list(PUNCTUATION)))
        else:
            phon = base + markers
            symbols = sorted(set(
                ["@" + s for s in phon]
                + list(PUNCTUATION)
                + ["@" + p for p in PUNCTUATION]))
    else:
        raise ValueError(f"{symbol_set} symbol set does not exist")

    return list(symbols), markers, placeholder_set, diphthongs
