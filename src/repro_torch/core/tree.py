"""Entity forest — the hierarchical knowledge structure of Tree-RAG.

All trees live in one flat node arena (device-friendly): parent pointers,
children CSR, per-node entity ids.  An entity (global vocabulary id) may
occur at many nodes across trees; ``entity_locations`` enumerates them and is
what the cuckoo filter's block linked lists index.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np

NULL = -1
Edge = Tuple[str, str]             # (parent_name, child_name)


@dataclasses.dataclass
class EntityForest:
    parent: np.ndarray             # (N,) int32 — global node index or NULL
    entity_id: np.ndarray          # (N,) int32 — global entity vocabulary id
    tree_id: np.ndarray            # (N,) int32
    depth: np.ndarray              # (N,) int32 — 0 at roots
    child_offsets: np.ndarray      # (N + 1,) int32 — CSR into child_index
    child_index: np.ndarray        # (total_children,) int32
    roots: np.ndarray              # (num_roots,) int32 global node indices
    entity_names: List[str]
    name_to_id: Dict[str, int]
    entity_locations: List[List[Tuple[int, int]]]  # per entity: [(tree, node)]
    num_trees: int

    # ------------------------------------------------------------------ sizes
    @property
    def num_nodes(self) -> int:
        return int(self.parent.shape[0])

    @property
    def num_entities(self) -> int:
        return len(self.entity_names)

    # ------------------------------------------------------- host traversals
    def children(self, node: int) -> np.ndarray:
        return self.child_index[self.child_offsets[node]:self.child_offsets[node + 1]]

    def ancestors(self, node: int, n: int) -> List[int]:
        """Up to n entity ids walking parent pointers upward (nearest first)."""
        out: List[int] = []
        p = int(self.parent[node])
        while p != NULL and len(out) < n:
            out.append(int(self.entity_id[p]))
            p = int(self.parent[p])
        return out

    def descendants(self, node: int, n: int) -> List[int]:
        """First n entity ids BFS-down from node (level order)."""
        out: List[int] = []
        q = deque(int(c) for c in self.children(node))
        while q and len(out) < n:
            c = q.popleft()
            out.append(int(self.entity_id[c]))
            q.extend(int(g) for g in self.children(c))
        return out

    def subtree_entities(self, node: int) -> set:
        """Entity-id set of node's subtree (incl. itself) — for Bloom builds."""
        seen = set()
        q = deque([node])
        while q:
            c = q.popleft()
            seen.add(int(self.entity_id[c]))
            q.extend(int(g) for g in self.children(c))
        return seen

    # ---------------------------------------------------------------- device
    def device_arrays(self):
        """Arrays to ship to the accelerator for vectorized context gather."""
        return dict(parent=self.parent, entity_id=self.entity_id,
                    child_offsets=self.child_offsets, child_index=self.child_index)


def build_forest(trees: Sequence[Sequence[Edge]]) -> EntityForest:
    """Build the flat forest from per-tree parent->child edge lists.

    A node is created per distinct entity name within each tree; names are
    shared across trees through the global entity vocabulary.
    """
    name_to_id: Dict[str, int] = {}
    entity_names: List[str] = []

    def eid(name: str) -> int:
        if name not in name_to_id:
            name_to_id[name] = len(entity_names)
            entity_names.append(name)
        return name_to_id[name]

    parent: List[int] = []
    entity_id: List[int] = []
    tree_id: List[int] = []
    roots: List[int] = []
    children_acc: List[List[int]] = []

    for t, edges in enumerate(trees):
        local: Dict[str, int] = {}          # name -> global node idx (this tree)
        has_parent: Dict[int, bool] = {}

        def node_of(name: str) -> int:
            if name not in local:
                g = len(parent)
                local[name] = g
                parent.append(NULL)
                entity_id.append(eid(name))
                tree_id.append(t)
                children_acc.append([])
                has_parent[g] = False
            return local[name]

        def is_ancestor(a: int, b: int) -> bool:
            """Would attaching b under a create a cycle? (is b above a?)"""
            g = a
            while g != NULL:
                if g == b:
                    return True
                g = parent[g]
            return False

        for pname, cname in edges:
            p = node_of(pname)
            c = node_of(cname)
            # first parent wins; never create a cycle within the tree
            if parent[c] == NULL and p != c and not is_ancestor(p, c):
                parent[c] = p
                children_acc[p].append(c)
                has_parent[c] = True
        for g in local.values():
            if not has_parent.get(g, False):
                roots.append(g)

    n = len(parent)
    parent_a = np.asarray(parent, dtype=np.int32) if n else np.zeros(0, np.int32)
    entity_a = np.asarray(entity_id, dtype=np.int32) if n else np.zeros(0, np.int32)
    tree_a = np.asarray(tree_id, dtype=np.int32) if n else np.zeros(0, np.int32)

    counts = np.asarray([len(c) for c in children_acc], dtype=np.int32)
    child_offsets = np.zeros(n + 1, dtype=np.int32)
    if n:
        np.cumsum(counts, out=child_offsets[1:])
    child_index = (np.concatenate([np.asarray(c, np.int32) for c in children_acc])
                   if any(children_acc) else np.zeros(0, np.int32))

    # depth by BFS from roots
    depth = np.zeros(n, dtype=np.int32)
    q = deque(roots)
    while q:
        g = q.popleft()
        lo, hi = child_offsets[g], child_offsets[g + 1]
        for c in child_index[lo:hi]:
            depth[c] = depth[g] + 1
            q.append(int(c))

    # per-entity locations
    locations: List[List[Tuple[int, int]]] = [[] for _ in entity_names]
    for g in range(n):
        locations[entity_a[g]].append((int(tree_a[g]), g))

    return EntityForest(
        parent=parent_a, entity_id=entity_a, tree_id=tree_a, depth=depth,
        child_offsets=child_offsets, child_index=child_index,
        roots=np.asarray(roots, dtype=np.int32),
        entity_names=entity_names, name_to_id=name_to_id,
        entity_locations=locations, num_trees=len(trees),
    )
