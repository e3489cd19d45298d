"""CLIP byte-level BPE tokenizer (host-side, pure Python).

A copy of efficientsam3_tpu/utils/tokenizer.py: the port keeps its own
copy of the JAX package's host code rather than importing it.

Functionally equivalent to the reference's vendored OpenAI CLIP tokenizer
(reference sam3/sam3/model/tokenizer_ve.py:128 SimpleTokenizer): 49408-token
vocabulary (256 bytes + 256 byte-with-</w> + 48894 merges + 2 specials),
lowercased, html-unescaped input, CLIP regex word splitting, byte-level BPE.

The merge table is loaded from the standard `bpe_simple_vocab_16e6.txt.gz`
asset (set via ``bpe_path`` or the EFFICIENTSAM3_BPE_PATH env var); we do not
bundle the asset. ftfy is optional (not in this image): we fall back to
NFC normalization + html unescape, which matches ftfy output for ordinary
prompts.

Tokenization is host-side by design: the device program takes fixed-length
(B, ctx) int32 token arrays.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import unicodedata
from typing import Iterable, List, Optional, Sequence

import numpy as np
import regex as re

try:  # optional, matches reference behavior when present
    import ftfy

    _HAS_FTFY = True
except ImportError:
    _HAS_FTFY = False

_WORD_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map (standard GPT-2/CLIP table)."""
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


def _get_pairs(word: tuple) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _clean(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    else:
        text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def default_bpe_path() -> Optional[str]:
    env = os.environ.get("EFFICIENTSAM3_BPE_PATH")
    if env and os.path.exists(env):
        return env
    candidates = [
        os.path.join(os.path.dirname(__file__), "..", "assets", "bpe_simple_vocab_16e6.txt.gz"),
    ]
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


class ClipTokenizer:
    """Byte-level BPE with the CLIP merge table."""

    def __init__(self, bpe_path: Optional[str] = None):
        bpe_path = bpe_path or default_bpe_path()
        if bpe_path is None:
            raise FileNotFoundError(
                "CLIP BPE vocab not found; set EFFICIENTSAM3_BPE_PATH to "
                "bpe_simple_vocab_16e6.txt.gz"
            )
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = _clean(text).lower()
        for chunk in re.findall(_WORD_PATTERN, text):
            chunk_b = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(chunk_b).split(" "))
        return tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(
        self, texts: Sequence[str] | str, context_length: int = 77
    ) -> np.ndarray:
        """Tokenize to a fixed (B, context_length) int32 array with SOT/EOT.

        Overlong prompts are truncated with EOT forced in the last slot
        (matching the reference tokenizer's truncate behavior).
        """
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            toks = [self.sot] + self.encode(t) + [self.eot]
            if len(toks) > context_length:
                toks = toks[:context_length]
                toks[-1] = self.eot
            out[i, : len(toks)] = toks
        return out
