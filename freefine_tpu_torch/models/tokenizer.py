"""CLIP BPE tokenizer (host-side, pure Python), the PyTorch port's own copy
of `freefine_tpu.models.tokenizer`.

Compatible with the vocab.json/merges.txt shipped in every SD-1.5 checkpoint
(`tokenizer/` subfolder) that the reference loads through diffusers
(`pipe.tokenizer`).  Implements the
OpenAI CLIP byte-pair encoding: bytes->unicode mapping, whitespace cleanup +
lowercasing, the CLIP token regex, BPE merges with the `</w>` end-of-word
convention, and 77-token padding with start/end specials.

When no vocab files are available (weight-free CI / random-weight benches) a
deterministic hash tokenizer stands in: same shapes and special-token layout,
stable ids for identical prompts.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (the GPT-2/CLIP trick)."""
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


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# CLIP's token regex; python's `re` lacks \p{L}/\p{N} classes, so this is
# the standard ASCII fallback (identical behaviour for English prompts).
_CLIP_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


class CLIPTokenizer:
    """BPE tokenizer; `encode` returns padded [max_length] int32 ids."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[Tuple[str, str]],
        max_length: int = 77,
    ):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.max_length = max_length
        self.bos = vocab.get("<|startoftext|>", len(vocab) - 2)
        self.eos = vocab.get("<|endoftext|>", len(vocab) - 1)
        self.cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, path: str, max_length: int = 77) -> "CLIPTokenizer":
        """Load from an SD checkpoint's `tokenizer/` dir (vocab.json +
        merges.txt) or an OpenAI-style bpe_simple_vocab_16e6.txt.gz."""
        vocab_json = os.path.join(path, "vocab.json")
        merges_txt = os.path.join(path, "merges.txt")
        if os.path.exists(vocab_json):
            with open(vocab_json, encoding="utf-8") as f:
                vocab = json.load(f)
            with open(merges_txt, encoding="utf-8") as f:
                lines = f.read().split("\n")
            merges = [
                tuple(l.split()) for l in lines
                if l and not l.startswith("#version") and len(l.split()) == 2
            ]
            return cls(vocab, merges, max_length)
        gz = os.path.join(path, "bpe_simple_vocab_16e6.txt.gz")
        with gzip.open(gz, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1]]
        byte_vocab = list(bytes_to_unicode().values())
        tokens = byte_vocab + [v + "</w>" for v in byte_vocab]
        tokens += ["".join(m) for m in merges]
        tokens += ["<|startoftext|>", "<|endoftext|>"]
        vocab = dict(zip(tokens, range(len(tokens))))
        return cls(vocab, merges, max_length)

    # -- BPE ----------------------------------------------------------------

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
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
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> List[int]:
        ids: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(_CLIP_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def encode(self, text: str) -> np.ndarray:
        """-> [max_length] int32: [bos, tokens..., eos, eos...] (CLIP pads
        with eos, which is what SD-1.5's tokenizer does)."""
        ids = [self.bos] + self.tokenize(text)[: self.max_length - 2] + [self.eos]
        ids = ids + [self.eos] * (self.max_length - len(ids))
        return np.asarray(ids, np.int32)

    def batch_encode(self, texts: List[str]) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts])


class HashTokenizer:
    """Deterministic stand-in tokenizer for weight-free tests and benches.

    Produces stable ids in [2, vocab_size) from a hash of each whitespace
    word, with the same bos/eos framing and padding as the real tokenizer.
    """

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos = 0
        self.eos = 1

    def encode(self, text: str) -> np.ndarray:
        words = whitespace_clean(basic_clean(text)).lower().split(" ")
        ids = [self.bos]
        for w in words:
            if not w:
                continue
            h = 2166136261
            for c in w.encode("utf-8"):  # FNV-1a
                h = ((h ^ c) * 16777619) & 0xFFFFFFFF
            ids.append(2 + h % (self.vocab_size - 2))
        ids = ids[: self.max_length - 1] + [self.eos]
        ids = ids + [self.eos] * (self.max_length - len(ids))
        return np.asarray(ids, np.int32)

    def batch_encode(self, texts: List[str]) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts])


def load_tokenizer(
    path: Optional[str] = None, vocab_size: int = 49408, max_length: int = 77
):
    """CLIPTokenizer if vocab files exist at `path`, else HashTokenizer."""
    if path is not None and (
        os.path.exists(os.path.join(path, "vocab.json"))
        or os.path.exists(os.path.join(path, "bpe_simple_vocab_16e6.txt.gz"))
    ):
        return CLIPTokenizer.from_pretrained(path, max_length)
    return HashTokenizer(vocab_size, max_length)
