"""Hash tokenizer — vocabulary-size-parameterized, deterministic, offline.

A copy of the reference's: every token maps to a stable id through the
same FNV-1a hash, so both packages encode a prompt to the same ids; a
reverse map of seen tokens supports decoding for demos.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence

from ..core import hashing

_TOKEN_RE = re.compile(r"[A-Za-z0-9]+|[^\sA-Za-z0-9]")


class HashTokenizer:
    PAD, BOS, EOS, SEP = 0, 1, 2, 3
    NUM_SPECIAL = 4

    def __init__(self, vocab_size: int):
        if vocab_size <= self.NUM_SPECIAL:
            raise ValueError(f"vocab_size {vocab_size} leaves no room past "
                             f"the {self.NUM_SPECIAL} special ids")
        self.vocab_size = vocab_size
        self._space = vocab_size - self.NUM_SPECIAL
        self._reverse: Dict[int, str] = {}

    def token_id(self, token: str) -> int:
        tid = int(hashing.fnv1a_64(token)) % self._space + self.NUM_SPECIAL
        self._reverse.setdefault(tid, token)
        return tid

    def encode(self, text: str, bos: bool = False, eos: bool = False
               ) -> List[int]:
        ids = [self.token_id(t) for t in _TOKEN_RE.findall(text)]
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            if i == self.PAD:
                continue
            if i == self.BOS:
                out.append("<s>")
            elif i == self.EOS:
                out.append("</s>")
            elif i == self.SEP:
                out.append("<sep>")
            else:
                out.append(self._reverse.get(int(i), f"<{int(i)}>"))
        return " ".join(out)
