"""Byte-level BPE tokenizer for CLIP text inputs.

Functionally equivalent to the OpenAI CLIP tokenizer the reference vendors
(`clip/tokenizer.py`, `clip/clip.py:187-212`):
49,408-entry vocabulary (256 byte symbols, 256 end-of-word byte symbols,
48,894 learned merges, 2 special tokens — see ``VOCAB_SIZE``/``_NUM_MERGES``
below; 49,152 is only the historical pre-slice merge-file budget), SOT/EOT
wrapping, zero padding and truncation to a 77-token context.  The merge table is a public data asset
(``assets/bpe_simple_vocab_16e6.txt.gz``, MIT-licensed by OpenAI).

Output is numpy ``int32`` — host-side tokenization feeds the device pipeline.
The word pattern's letter and number classes (Unicode categories L* and N*,
which the original pattern reads through the ``regex`` module) are built from
:mod:`unicodedata`, so the tokenizer runs on the standard library alone.  The
two agree on every character of Python's Unicode database; characters
assigned in later Unicode versions are outside both classes here.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import sys
import unicodedata
from typing import Iterable, List, Sequence, Union

import numpy as np

from flyp_tpu_torch.tokenizer.cleaning import fix_text as _fix_text


VOCAB_SIZE = 49408  # 2*256 byte symbols + 48,894 merges + 2 special tokens
CONTEXT_LENGTH = 77
SOT_TEXT = "<start_of_text>"
EOT_TEXT = "<end_of_text>"

_ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "bpe_simple_vocab_16e6.txt.gz")

# Number of learned merges kept from the published merge file.  CLIP keeps
# 48,894 merges (the historical `49152-256-2+1` slice of the merge file),
# yielding the 49,408-entry vocabulary every OpenAI checkpoint embeds.
_NUM_MERGES = 48894


@functools.lru_cache()
def _byte_to_unicode() -> dict:
    """Invertible byte -> printable-unicode map (GPT-2 convention).

    Printable ASCII/Latin-1 bytes map to themselves; the remaining bytes are
    assigned codepoints starting at 256 so no token string ever contains
    whitespace or control characters.
    """
    visible = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping = {b: chr(b) for b in visible}
    fill = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + fill)
            fill += 1
    return mapping


# Unicode White_Space, what ``\s`` matches in the ``regex`` module (the
# standard ``re`` also matches the separators U+001C..U+001F).
_WS = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
_WS_RUN = re.compile(f"[{_WS}]+")


def _category_class(prefix: str) -> str:
    """A character-class body of every code point whose Unicode general
    category starts with ``prefix`` ("L" letters, "N" numbers)."""
    ranges, start = [], None
    for cp in range(sys.maxunicode + 2):
        inside = cp <= sys.maxunicode and unicodedata.category(chr(cp)).startswith(prefix)
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            ranges.append(re.escape(chr(start)) if start == cp - 1 else f"{re.escape(chr(start))}-{re.escape(chr(cp - 1))}")
            start = None
    return "".join(ranges)


@functools.lru_cache()
def _word_classes() -> tuple:
    return _category_class("L"), _category_class("N")


def _clean_text(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    text = _WS_RUN.sub(" ", text)
    return text.strip().lower()


class ClipTokenizer:
    """CLIP byte-level BPE with the published 16e6 merge table."""

    def __init__(self, bpe_path: str = _ASSET, special_tokens: Sequence[str] | None = None):
        self.byte_encoder = _byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # First line is a version header; keep exactly the merge budget.
        merge_pairs = [tuple(line.split()) for line in lines[1 : _NUM_MERGES + 1]]

        specials = [SOT_TEXT, EOT_TEXT] + list(special_tokens or [])
        vocab: List[str] = list(self.byte_encoder.values())
        vocab += [tok + "</w>" for tok in self.byte_encoder.values()]
        vocab += ["".join(pair) for pair in merge_pairs]
        vocab += specials

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.merge_rank = {pair: i for i, pair in enumerate(merge_pairs)}
        self._bpe_cache = {tok: tok for tok in specials}

        self.sot_token = self.encoder[SOT_TEXT]
        self.eot_token = self.encoder[EOT_TEXT]
        self.vocab_size = len(self.encoder)
        self.all_special_ids = [self.encoder[t] for t in specials]

        special_alt = "|".join(re.escape(s) for s in specials)
        letters, numbers = _word_classes()
        # Case-insensitive matching applies to the contractions only: under
        # re.IGNORECASE a class built from code-point ranges would also
        # match characters whose case fold lands in it.  The one character
        # that case-folding moves between the classes of the original
        # pattern, U+0345 (folds to a Greek letter), is matched by none of
        # them there and is dropped; the "other" class excludes it here too.
        self._word_pat = re.compile(
            special_alt
            + f"|(?i:'s|'t|'re|'ve|'m|'ll|'d)|[{letters}]+|[{numbers}]|[^{_WS}{letters}{numbers}\u0345]+"
        )

    # -- BPE core -----------------------------------------------------------

    def _apply_bpe(self, token: str) -> str:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached

        if len(token) == 1:
            out = token + "</w>"
            self._bpe_cache[token] = out
            return out

        parts = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            # Find the adjacent pair with the lowest merge rank.
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                rank = self.merge_rank.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
                    best_i = i
            if best_rank is None:
                break
            first, second = parts[best_i], parts[best_i + 1]
            merged = first + second
            # Merge *every* occurrence of this pair left-to-right, matching
            # the classic BPE merge step (a merged element is never re-paired
            # with its own right neighbour within the same pass).
            new_parts: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and parts[i] == first and parts[i + 1] == second:
                    new_parts.append(merged)
                    i += 2
                else:
                    new_parts.append(parts[i])
                    i += 1
            parts = new_parts

        out = " ".join(parts)
        self._bpe_cache[token] = out
        return out

    # -- public API ---------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self._word_pat.findall(_clean_text(text)):
            word_bytes = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._apply_bpe(word_bytes).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Union[str, Sequence[str]], context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        return tokenize(texts, context_length=context_length, tokenizer=self)


@functools.lru_cache()
def get_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    tokenizer: ClipTokenizer | None = None,
) -> np.ndarray:
    """Tokenize text(s) to a zero-padded ``[n, context_length]`` int32 array.

    Matches the reference semantics (`clip/clip.py:187-212`):
    SOT + BPE ids + EOT, truncated to ``context_length`` (truncation may drop
    the EOT, as upstream does), right-padded with zeros.  The EOT position is
    recoverable as ``argmax`` along the last axis because EOT has the highest
    id of any emitted token.
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = tokenizer or get_tokenizer()

    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for row, text in enumerate(texts):
        ids = [tok.sot_token] + tok.encode(text) + [tok.eot_token]
        ids = ids[:context_length]
        out[row, : len(ids)] = ids
    return out


def shrink_context(tokens: np.ndarray, bucket: int = 16) -> np.ndarray:
    """Slice a padded ``[B, context]`` token batch to the smallest multiple
    of ``bucket`` covering every row's EOT position.

    Exact, not approximate: the text tower is CAUSAL and pools at the
    argmax-id (EOT) position (`clip/model.py:359`), so
    positions after a row's pooling index can never influence its feature.
    The reference pads every caption to 77 tokens (`clip/clip.py:204`) and
    pays full quadratic attention on padding; prompt-templated captions are
    typically under 24 tokens, so bucketed shrinking cuts the text tower's
    work ~2.4x with bit-identical math (only fp reduction order within
    unchanged contractions differs).  Host-side: call before device_put; a
    handful of bucket lengths means a handful of compiled shapes.
    """
    t = np.asarray(tokens)
    if t.ndim != 2 or t.shape[1] <= bucket:
        return t
    maxlen = int(t.argmax(axis=-1).max()) + 1
    L = min(t.shape[1], -(-maxlen // bucket) * bucket)
    return np.ascontiguousarray(t[:, :L])
