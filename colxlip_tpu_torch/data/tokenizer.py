"""CLIP byte-BPE tokenizer: pure-Python port of ``colxlip_tpu/data/tokenizer.py``.

Token ids are identical to the JAX package's, including its zero-merges
offline fallback: without a merge table (``$COLXLIP_BPE_PATH`` or
``colxlip_tpu/data/bpe_simple_vocab_16e6.txt.gz``) every word is byte-level
(ids 0-511). SOT and EOT stay pinned at 49406 and 49407, so EOT is the
largest id of every row, which the text tower's argmax pooling relies on.

Printable-ASCII captions go to the port's C++ BPE core
(``native/bpe_tokenizer.cc``), whose ids equal the Python path's, as in the
JAX package; ``COLXLIP_NATIVE_TOKENIZER=0`` keeps every caption on the
Python path. Unlike the JAX tokenizer, which logs a warning and stays in
Python when the core does not build, the port raises: the variable is the
one way to the Python path.
"""
from __future__ import annotations

import functools
import gzip
import html
import logging
import os
import pathlib
import re as _stdlib_re
import threading
from typing import List, Optional, Sequence, Union

import numpy as np

from .textfix import fix_text

logger = logging.getLogger(__name__)

try:
    import regex as re  # \p{L}/\p{N} classes like the original

    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        re.IGNORECASE,
    )
except ImportError:  # the JAX tokenizer falls back to the same ASCII pattern
    import re

    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+""",
        re.IGNORECASE,
    )

CONTEXT_LENGTH = 77
SOT_TOKEN = 49406
EOT_TOKEN = 49407
DEFAULT_BPE_ENV = "COLXLIP_BPE_PATH"
# the port's own asset location: the BPE file goes beside this module
_DATA_DIR = pathlib.Path(__file__).resolve().parent
_BPE_NAME = "bpe_simple_vocab_16e6.txt.gz"


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (GPT-2/CLIP standard)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def basic_clean(text: str) -> str:
    text = fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    import re as _re

    return _re.sub(r"\s+", " ", text).strip()


def _find_default_bpe() -> Optional[str]:
    p = os.environ.get(DEFAULT_BPE_ENV)
    if p and os.path.exists(p):
        return p
    here = _DATA_DIR / _BPE_NAME
    return str(here) if here.exists() else None


class SimpleTokenizer:
    """CLIP BPE tokenizer (+ zero-merge byte fallback)."""

    def __init__(self, context_length: int = CONTEXT_LENGTH):
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()

        bpe_path = _find_default_bpe()
        merges: list = []
        if bpe_path is not None:
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            merges = [tuple(m.split()) for m in lines[1:49152 - 256 - 2 + 1]]
        self._merges = merges
        self._native_lock = threading.Lock()   # loader threads share one tokenizer
        self._native_tried = False
        self._native_handle: Optional[int] = None
        self._native_free = None
        self.has_merges = bool(merges)
        if not self.has_merges:
            logger.warning(
                "CLIP BPE merge table (%s) not found: tokenizing with the "
                "ZERO-MERGES byte fallback, which is NOT bit-compatible with "
                "CLIP (wrong for pretrained checkpoints). Set $%s.",
                _BPE_NAME, DEFAULT_BPE_ENV)

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        # specials pinned to the canonical CLIP ids regardless of merge count
        self.encoder["<|startoftext|>"] = SOT_TOKEN
        self.encoder["<|endoftext|>"] = EOT_TOKEN
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot_token = SOT_TOKEN
        self.eot_token = EOT_TOKEN

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not self.bpe_ranks:
            out = " ".join(word)
            self.cache[token] = out
            return out
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, tokens) -> str:
        """Ids -> text: each id's BPE string, bytes decoded as UTF-8 (bad
        bytes replaced), '</w>' word ends as spaces; an unknown id is
        dropped and an unknown character reads as a space, as in JAX."""
        text = "".join(self.decoder.get(int(t), "") for t in tokens)
        return (bytearray(self.byte_decoder.get(c, 32) for c in text)
                .decode("utf-8", errors="replace").replace("</w>", " "))

    # The native core handles only clean printable ASCII: '<' could form a
    # special-token literal, '&' an HTML entity (basic_clean unescapes), and
    # \x1c-\x1f are Python-regex whitespace the C scanner does not model.
    _NATIVE_ELIGIBLE = _stdlib_re.compile(r"^[\t\n\r\x20-\x7e]*$")

    def _get_native(self) -> Optional[int]:
        """The handle of the C++ BPE core over this merge table, built at
        first use; None when ``COLXLIP_NATIVE_TOKENIZER=0``. A failed build
        raises (``native.build``)."""
        with self._native_lock:
            if not self._native_tried:
                self._native_tried = True
                if os.environ.get("COLXLIP_NATIVE_TOKENIZER", "1") != "0":
                    from .. import native

                    blob = "\n".join(" ".join(m) for m in self._merges).encode("utf-8")
                    self._native_handle = native.bpe_init(blob)
                    self._native_free = native.bpe_free
            return self._native_handle

    def __del__(self):
        # each handle holds the whole encoder and rank maps natively
        handle = getattr(self, "_native_handle", None)
        if handle is not None:
            self._native_handle = None
            try:
                self._native_free(handle)
            except (AttributeError, TypeError):   # the native module torn down at exit
                pass

    def __call__(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        """Zero-padded [n, context_length] int32 ids; over-long inputs are
        truncated with EOT forced into the last slot (open_clip semantics).
        Printable-ASCII strings take the C++ core, the rest the Python path."""
        if isinstance(texts, str):
            texts = [texts]
        context_length = self.context_length
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        native_handle = self._get_native()
        native_idx = []
        for i, text in enumerate(texts):
            if native_handle is not None and self._NATIVE_ELIGIBLE.match(text) \
                    and "<" not in text and "&" not in text:
                native_idx.append(i)
                continue
            tokens = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(tokens) > context_length:
                tokens = tokens[:context_length]
                tokens[-1] = self.eot_token
            result[i, :len(tokens)] = tokens
        if native_idx:
            from .. import native

            result[np.asarray(native_idx)] = native.bpe_encode_batch(
                native_handle, [texts[i].encode("ascii") for i in native_idx],
                context_length)
        return result


@functools.lru_cache()
def get_tokenizer_cached(context_length: int = CONTEXT_LENGTH) -> SimpleTokenizer:
    return SimpleTokenizer(context_length=context_length)
