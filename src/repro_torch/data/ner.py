"""Entity recognition — deterministic spaCy stand-in (paper §2.1).

The paper uses spaCy's statistical NER to pull entities out of user queries.
Offline we replace it with the two mechanisms that matter for Tree-RAG:

1. **Gazetteer matching** — maximal-span match against the knowledge base's
   entity vocabulary (in production T-RAG the recognized entities are only
   useful if they exist in the forest anyway).
2. **Capitalization heuristics** — contiguous TitleCase token runs are
   surfaced as candidate entities (emulating spaCy's PERSON/ORG behaviour on
   unseen names) so the pipeline also works before the forest is built.

Deterministic, dependency-free, and O(len(text)) with a token-trie.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence

_TOKEN_RE = re.compile(r"[A-Za-z0-9_]+(?:'[a-z]+)?")

_STOP = {"The", "A", "An", "In", "On", "Of", "And", "Or", "What", "Which",
         "How", "Who", "Where", "When", "Describe", "It", "Its", "This"}


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text)


class _Trie:
    __slots__ = ("children", "terminal")

    def __init__(self):
        self.children: Dict[str, "_Trie"] = {}
        self.terminal: Optional[str] = None


def add_to_gazetteer(root: _Trie, entity: str) -> None:
    """Register one more entity name on a live gazetteer (dynamic bank
    maintenance inserts entities after the trie was built)."""
    node = root
    for tok in tokenize(entity):
        node = node.children.setdefault(tok.lower(), _Trie())
    node.terminal = entity


def build_gazetteer(entities: Iterable[str]) -> _Trie:
    root = _Trie()
    for ent in entities:
        add_to_gazetteer(root, ent)
    return root


def recognize_entities(text: str, gazetteer: Optional[_Trie] = None,
                       use_heuristics: bool = True) -> List[str]:
    """Entities in order of first occurrence, de-duplicated."""
    toks = tokenize(text)
    found: List[str] = []
    seen = set()
    i = 0
    while i < len(toks):
        match = None
        match_len = 0
        if gazetteer is not None:          # maximal-span gazetteer match
            node = gazetteer
            j = i
            while j < len(toks) and toks[j].lower() in node.children:
                node = node.children[toks[j].lower()]
                j += 1
                if node.terminal is not None:
                    match, match_len = node.terminal, j - i
        if match is None and use_heuristics:
            j = i
            while (j < len(toks) and toks[j][:1].isupper()
                   and toks[j] not in _STOP):
                j += 1
            if j - i >= 2 or (j - i == 1 and i > 0):   # sentence-initial 1-tok
                match, match_len = " ".join(toks[i:j]), j - i
        if match is not None:
            if match not in seen:
                seen.add(match)
                found.append(match)
            i += match_len
        else:
            i += 1
    return found
