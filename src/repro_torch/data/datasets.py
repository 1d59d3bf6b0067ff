"""Synthetic corpora mirroring the paper's two datasets (§4.3).

* ``unhcr_corpus``    — UNHCR-style organizational charts: pre-segmented
  hierarchy (the original dataset ships as entity pairs), deep org trees.
* ``hospital_corpus`` — hospital-history documents: raw text whose relations
  must be *extracted* (the paper runs dependency parsing on this one), with
  department / ward / clinic hierarchies.

Both are deterministic given a seed and scale to the paper's sizes (600
trees, ~3k entities).  Each corpus carries gold trees so retrieval accuracy
is measurable without an LLM judge (see DESIGN.md §7 accuracy proxy).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Sequence, Tuple

Edge = Tuple[str, str]

_ORG_UNITS = ["Division", "Bureau", "Section", "Unit", "Service", "Office",
              "Team", "Desk", "Mission", "Programme"]
_ORG_THEMES = ["Protection", "Operations", "Relief", "Logistics", "Health",
               "Shelter", "Registration", "Resettlement", "Field", "Policy",
               "Donor", "Legal", "Supply", "Education", "Emergency"]
_HOSP_UNITS = ["Department", "Ward", "Clinic", "Laboratory", "Center",
               "Institute", "Pharmacy", "Unit", "Station", "Group"]
_HOSP_THEMES = ["Cardiology", "Oncology", "Neurology", "Pediatrics",
                "Radiology", "Surgery", "Orthopedics", "Pathology",
                "Anesthesia", "Dermatology", "Urology", "Gastroenterology",
                "Hematology", "Nephrology", "Respiratory"]

_RELATION_TEMPLATES = [
    "{child} belongs to {parent}.",
    "{parent} contains {child}.",
    "{child} is part of {parent}.",
    "{child} is dependent on {parent}.",
    "{child} and {sibling} belong to {parent}.",
]

_QUERY_TEMPLATES = [
    "What is the role of {e} in the organization?",
    "Describe the history of {e} and its parent units.",
    "Which teams report to {e}?",
    "How does {e} relate to its departments?",
]


@dataclasses.dataclass
class SyntheticCorpus:
    name: str
    documents: List[str]               # raw text (relation sentences + noise)
    trees: List[List[Edge]]            # gold hierarchy per tree
    entities: List[str]                # gold entity vocabulary
    queries: List[str]                 # natural-language queries
    query_entities: List[List[str]]    # gold entities per query

    @property
    def num_entities(self) -> int:
        return len(self.entities)


def _make_tree(rng: random.Random, prefix: str, units: Sequence[str],
               themes: Sequence[str], depth: int, branching: int) -> List[Edge]:
    """Random tree of named units; names unique within the tree."""
    counter = [0]

    def name() -> str:
        counter[0] += 1
        return (f"{rng.choice(themes)} {rng.choice(units)} "
                f"{prefix}{counter[0]}")

    edges: List[Edge] = []
    root = f"{rng.choice(themes)} Headquarters {prefix}0"
    frontier = [root]
    for _ in range(depth):
        nxt: List[str] = []
        for parent in frontier:
            for _ in range(rng.randint(1, branching)):
                child = name()
                edges.append((parent, child))
                nxt.append(child)
        frontier = nxt or frontier
        if not nxt:
            break
    return edges


def _corpus(name: str, units: Sequence[str], themes: Sequence[str],
            num_trees: int, depth: int, branching: int, num_queries: int,
            entities_per_query: int, seed: int,
            shared_entity_rate: float) -> SyntheticCorpus:
    rng = random.Random(seed)
    trees = [_make_tree(rng, f"T{t}_", units, themes, depth, branching)
             for t in range(num_trees)]

    # cross-tree shared entities: the same unit appearing in several trees is
    # what makes block linked lists non-trivial (multiple addresses/entity).
    all_names = sorted({n for tr in trees for e in tr for n in e})
    members = [sorted({n for e in tr for n in e}) for tr in trees]
    shared = rng.sample(all_names, max(1, int(len(all_names) * shared_entity_rate)))
    for s in shared:
        for _ in range(rng.randint(1, 3)):
            t = rng.randrange(num_trees)
            if s in members[t]:
                continue           # only graft where absent: keeps trees acyclic
            host = rng.choice(members[t])
            trees[t].append((host, s))
            members[t].append(s)

    entities = sorted({n for tr in trees for e in tr for n in e})

    documents: List[str] = []
    for tr in trees:
        sentences = []
        for parent, child in tr:
            tpl = rng.choice(_RELATION_TEMPLATES)
            sibling = rng.choice(entities)
            sentences.append(tpl.format(parent=parent, child=child,
                                        sibling=sibling))
            if rng.random() < 0.3:
                sentences.append(
                    f"In recent years, {child} expanded its mandate "
                    f"under the guidance of {parent}.")
        documents.append(" ".join(sentences))

    queries, query_entities = [], []
    for _ in range(num_queries):
        ents = rng.sample(entities, min(entities_per_query, len(entities)))
        q = " ".join(rng.choice(_QUERY_TEMPLATES).format(e=e) for e in ents)
        queries.append(q)
        query_entities.append(ents)

    return SyntheticCorpus(name=name, documents=documents, trees=trees,
                           entities=entities, queries=queries,
                           query_entities=query_entities)


def unhcr_corpus(num_trees: int = 50, depth: int = 4, branching: int = 3,
                 num_queries: int = 64, entities_per_query: int = 5,
                 seed: int = 20250114) -> SyntheticCorpus:
    """UNHCR-style org charts (pre-segmented hierarchy)."""
    return _corpus("unhcr", _ORG_UNITS, _ORG_THEMES, num_trees, depth,
                   branching, num_queries, entities_per_query, seed,
                   shared_entity_rate=0.05)


def hospital_corpus(num_trees: int = 600, depth: int = 3, branching: int = 3,
                    num_queries: int = 64, entities_per_query: int = 5,
                    seed: int = 20250607) -> SyntheticCorpus:
    """Hospital-history corpus (relations must be extracted from text)."""
    return _corpus("hospital", _HOSP_UNITS, _HOSP_THEMES, num_trees, depth,
                   branching, num_queries, entities_per_query, seed,
                   shared_entity_rate=0.08)
