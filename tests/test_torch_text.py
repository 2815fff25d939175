"""radmmm_torch's text frontend against the JAX package's: the symbol
tables of every symbol set, and the token ids ``encode_text`` gives for
every cleaner, for grapheme-to-phoneme lookup through CMUdict with its
heteronyms and through per-language phonemizer dictionaries, for
sentences with numbers, currency, dates, times, ordinals and acronyms,
and for the first lines of every shipped filelist. Ids are held exactly."""
import glob
import os

import pytest

from radmmm_tpu.text import processing as jax_processing
from radmmm_tpu.text import symbols as jax_symbols
from radmmm_torch.text import processing, symbols
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYMBOL_SETS = ("english_basic", "english_basic_lowercase",
               "english_expanded", "radtts", "radmmm",
               "radmmm_phonemizer_exhaustive",
               "radmmm_phonemizer_marker_segregated")
CLEANERS = ("basic_cleaners", "english_cleaners", "radtts_cleaners",
            "transliteration_cleaners")
SENTENCES = (
    "I paid $5.50 at 10:30pm on June 3rd, 1984!",
    "The NASA and FBI reports cost £12 million in 2021.",
    "Dr. Smith read 1,234 lines; he will read them again on 1/2/2003.",
    "Please record the record of the 21st century project, okay?",
    "He lives at 42 Wind Street and wound the 3 clocks.",
    "hello {HH AH0 L OW1} world, it's the 4th of July.",
    "Café naïve résumé: the 2nd item costs €3.",
    "USA, UK, and the E.U. met at 9am.",
)
# words of SENTENCES per language, for the phonemizer dictionaries
G2P = {
    "en_US": {"i": "aɪ", "paid": "pˈeɪd", "at": "æt", "on": "ɑːn",
              "the": "ðə", "record": "ɹˈɛkɚd", "of": "ʌv", "hello": "həlˈoʊ",
              "world": "wˈɜːld", "he": "hiː", "read": "ɹˈiːd"},
    "es_ES": {"hola": "ˈola", "mundo": "mˈundo", "el": "el"},
    "de_DE": {"guten": "ɡˈuːtən", "tag": "tˈaːk"},
    "fr_FR": {"bonjour": "bɔ̃ʒˈuʁ"},
    "hi_HI": {"नमस्ते": "nəmˈəsteː"},
    "pt_BR": {"olá": "olˈa"},
}
FILELIST_LANGUAGES = {"LJSpeech": "en_US", "HUI-Audio-Corpus-German": "de_DE",
                      "es_ES": "es_ES", "es_MX": "es_MX", "fr_FR": "fr_FR",
                      "TTS-Portuguese-Corpus": "pt_BR",
                      "indic-languages-tts-iiit-h": "hi_HI"}
FILELISTS = sorted(glob.glob(os.path.join(ROOT, "datasets", "opensource",
                                          "**", "*.txt"), recursive=True))
LINES_PER_FILELIST = 20


@pytest.mark.parametrize("name", SYMBOL_SETS)
def test_symbol_tables_match_jax(name):
    assert symbols.get_symbols(name) == jax_symbols.get_symbols(name)


def _pair(*args, **kw):
    return (processing.TextProcessing(*args, **kw),
            jax_processing.TextProcessing(*args, **kw))


def _same_ids(port, ref, text, **kw):
    got = port.encode_text(text, return_all=True, **kw)
    want = ref.encode_text(text, return_all=True, **kw)
    assert got == want, text


@pytest.mark.parametrize("cleaner", CLEANERS)
@pytest.mark.parametrize("ambiguous", ("first", "ignore", "random"))
def test_cmudict_encoding_matches_jax(cleaner, ambiguous):
    """g2p through assets/cmudict-0.7b with assets/heteronyms, ARPAbet
    tokens (the reference's radtts symbol set)."""
    port, ref = _pair(
        "radtts", [cleaner], os.path.join(ROOT, "assets", "heteronyms"),
        os.path.join(ROOT, "assets", "cmudict-0.7b"), p_phoneme=1.0,
        handle_phoneme="word", handle_phoneme_ambiguous=ambiguous,
        prepend_space_to_text=True, append_space_to_text=True,
        g2p_type="custom")
    for text in SENTENCES:
        _same_ids(port, ref, text)


@pytest.mark.parametrize("cleaner", CLEANERS)
def test_phonemizer_encoding_matches_jax(cleaner, tmp_path):
    """Per-language word -> IPA dictionaries, the recipe's symbol set."""
    cfg = {}
    for lang, words in G2P.items():
        path = tmp_path / f"{lang}.tsv"
        path.write_text("".join(f"{w}\t{p}\n" for w, p in words.items()),
                        encoding="utf-8")
        cfg[lang] = str(path)
    port, ref = _pair("radmmm_phonemizer_marker_segregated", [cleaner],
                      g2p_type="phonemizer", phonemizer_cfg=cfg,
                      handle_phoneme_ambiguous="first",
                      prepend_space_to_text=True, append_space_to_text=True,
                      add_bos_eos_to_text=True, encoding="utf-8")
    assert port.symbols == ref.symbols
    for lang in G2P:
        for text in SENTENCES + ("hola mundo, guten Tag", "bonjour olá",
                                 "नमस्ते 12"):
            _same_ids(port, ref, text, language=lang)


@pytest.mark.parametrize("path", FILELISTS,
                         ids=[os.path.basename(p) for p in FILELISTS])
def test_shipped_filelists_encode_as_jax(path, tmp_path):
    """The recipe's text settings on the first lines of each filelist:
    phonemized lists as IPA, the others through the phonemizer with an
    empty dictionary (graphemes, as the recipe's German train split)."""
    lang = next(v for k, v in FILELIST_LANGUAGES.items() if f"/{k}/" in path)
    empty = tmp_path / "empty.tsv"
    empty.write_text("")
    port, ref = _pair("radmmm_phonemizer_marker_segregated",
                      ["radtts_cleaners"],
                      os.path.join(ROOT, "assets", "heteronyms"),
                      os.path.join(ROOT, "assets", "cmudict-0.7b"),
                      handle_phoneme="word", handle_phoneme_ambiguous="first",
                      prepend_space_to_text=True, append_space_to_text=True,
                      g2p_type="phonemizer",
                      phonemizer_cfg={lang: str(empty)})
    phonemized = "phonemized" in os.path.basename(path)
    with open(path, encoding="utf-8") as f:
        lines = [line.split("|")[1] for line, _ in
                 zip(f, range(LINES_PER_FILELIST))]
    assert lines
    for text in lines:
        _same_ids(port, ref, text, language=lang, is_phonemized=phonemized)
