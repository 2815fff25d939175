"""The text frontend: cleaners, grapheme-to-phoneme lookup, symbol sets
and ``TextProcessing``. A copy owned by the port of radmmm_tpu/text/
(pure Python over re and numpy), held to it by tests/test_torch_text.py."""
from radmmm_torch.text.processing import TextProcessing
from radmmm_torch.text.symbols import get_symbols
