"""Ragged filter-bank arena — T per-tree cuckoo filters in one flat table.

The paper's many-tree regime keeps one cuckoo filter *per tree*.  Real
entity forests are skewed, so the bank stores a **ragged bucket arena**:
each tree ``t`` owns an independent power-of-two bucket count
``tree_nb[t]``, its buckets live as the contiguous arena segment
``[bucket_offsets[t], bucket_offsets[t+1])`` of one flat
``(total_buckets, S)`` table, and a routed lookup probes rows
``bucket_offsets[t] + (i & (tree_nb[t] - 1))``.

Build path: one vectorized pass over *all* trees at once.  Hash,
fingerprint and both candidate buckets are computed for every
(tree, entity) item in a single numpy batch with per-item bucket masks,
empty slots are claimed by grouped rank assignment
(:func:`repro_torch.core.cuckoo.bulk_place`), and only the tiny remainder
walks the scalar eviction chain.  If a kick chain exhausts, only the
failing tree doubles its bucket count and the bank rebuilds.  The build
is seeded, so the same forest always yields byte-identical tables.

Slot payloads are *bank CSR rows*: each (tree, entity) pair that occurs in
the forest owns one row of ``csr_offsets``/``csr_nodes`` listing the node
ids of that entity within that tree, so a routed lookup yields only
locations inside the queried tree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from . import hashing
from .cuckoo import (DEFAULT_LOAD_THRESHOLD, DEFAULT_MAX_KICKS,
                     DEFAULT_SLOTS, NULL, bulk_place)
from .tree import EntityForest

DEFAULT_LOAD_TARGET = 0.85         # size nb_t so per-tree load stays under this
EMPTY_TREE_NB = 1                  # buckets for a tree holding zero entities


@dataclasses.dataclass
class FilterBank:
    """T per-tree cuckoo filters as one ragged arena + the CSR location
    arena.  ``fingerprints``/``temperature``/``heads``/``entity_ids``/
    ``stored_hash`` are flat ``(total_buckets, S)``; tree ``t`` owns arena
    rows ``[bucket_offsets[t], bucket_offsets[t+1])`` with its own
    power-of-two ``tree_nb[t]``."""
    num_trees: int
    tree_nb: np.ndarray            # (T,) int32 — per-tree buckets, powers of 2
    bucket_offsets: np.ndarray     # (T + 1,) int64 — arena segment starts
    slots: int
    fingerprints: np.ndarray       # (A, S) uint32 — 0 = empty
    temperature: np.ndarray        # (A, S) int32
    heads: np.ndarray              # (A, S) int32 — bank CSR row id
    entity_ids: np.ndarray         # (A, S) int32 — global entity id
    stored_hash: np.ndarray        # (A, S) uint32 — host-only (restage)
    csr_offsets: np.ndarray        # (R + 1,) int32
    csr_nodes: np.ndarray          # (L,) int32 — global node ids per row
    row_tree: np.ndarray           # (R,) int32
    row_entity: np.ndarray         # (R,) int32
    num_items: np.ndarray          # (T,) int32
    build_stats: Dict[str, int]

    @property
    def num_rows(self) -> int:
        return int(self.row_tree.shape[0])

    @property
    def total_buckets(self) -> int:
        """Arena rows == sum(tree_nb)."""
        return int(self.fingerprints.shape[0])

    @property
    def load_factors(self) -> np.ndarray:
        return self.num_items / (self.tree_nb.astype(np.float64)
                                 * self.slots)

    def segment(self, tree: int) -> Tuple[int, int]:
        """Arena row range [lo, hi) owned by ``tree``."""
        return (int(self.bucket_offsets[tree]),
                int(self.bucket_offsets[tree + 1]))


def pad_csr(offsets: np.ndarray, nodes: np.ndarray, chunk: int = 256
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the CSR staging arrays to a pow2-chunked capacity (floored at
    ``chunk`` entries) so the device state's shapes stay constant until
    the arena actually doubles.  The pad tail is inert: ``offsets``
    repeats the terminal offset (every pad row is empty) and ``nodes``
    pads with zeros that no live row can address."""
    off = np.asarray(offsets, np.int32)
    nd = np.asarray(nodes, np.int32)
    if nd.size == 0:
        nd = np.zeros(1, np.int32)
    cap = lambda n: max(chunk, int(2 ** np.ceil(np.log2(n))))  # noqa: E731
    po = np.full(cap(off.size), off[-1], np.int32)
    po[:off.size] = off
    pn = np.zeros(cap(nd.size), np.int32)
    pn[:nd.size] = nd
    return po, pn


# ------------------------------------------------------------------- build

def _bank_rows(forest: EntityForest):
    """Enumerate (tree, entity) rows and their node lists with one lexsort
    of the forest's flat node arrays.  Rows come out entity-major, trees
    ascending within an entity, node ids ascending within a row."""
    entity_hashes = hashing.hash_entities(forest.entity_names)
    n = forest.num_nodes
    if n == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(1, np.int32), np.zeros(0, np.int32), entity_hashes)
    ent = forest.entity_id.astype(np.int64)
    tre = forest.tree_id.astype(np.int64)
    nodes = np.arange(n, dtype=np.int64)
    order = np.lexsort((nodes, tre, ent))      # by entity, tree, node
    e_s, t_s, n_s = ent[order], tre[order], nodes[order]
    new_row = np.r_[True, (e_s[1:] != e_s[:-1]) | (t_s[1:] != t_s[:-1])]
    row_tree = t_s[new_row].astype(np.int32)
    row_entity = e_s[new_row].astype(np.int32)
    counts = np.bincount(np.cumsum(new_row) - 1, minlength=row_tree.size)
    offsets = np.zeros(row_tree.size + 1, dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    return row_tree, row_entity, offsets, n_s.astype(np.int32), entity_hashes


def _pick_tree_buckets(per_tree: np.ndarray, slots: int,
                       load_target: float) -> np.ndarray:
    """Per-tree bucket pick: the smallest power of two (>= 4) keeping that
    tree under ``load_target``; an *empty* tree gets ``EMPTY_TREE_NB``."""
    need = np.maximum(1, np.ceil(per_tree / (slots * load_target)))
    nb = np.maximum(4, 2 ** np.ceil(np.log2(need))).astype(np.int64)
    return np.where(per_tree > 0, nb, EMPTY_TREE_NB).astype(np.int64)


def _scalar_insert(fps: np.ndarray, temps: np.ndarray, heads: np.ndarray,
                   eids: np.ndarray, hs: np.ndarray, base: int, nb: int,
                   slots: int, h: int, row: int, eid: int, rng,
                   max_kicks: int, temp: int = 0) -> bool:
    """Scalar cuckoo insert into flat bank tables, confined to one tree's
    arena segment [base, base + nb).  Temperature rides along the kick
    chain so displaced hot slots keep their heat."""
    h = np.uint32(h)
    fp = hashing.fingerprint(h)
    i1 = int(hashing.bucket_i1(h, nb))
    i2 = int(hashing.alt_bucket(np.uint32(i1), fp, nb))
    for i in (base + i1, base + i2):
        empty = np.nonzero(fps[i] == hashing.EMPTY_FP)[0]
        if empty.size:
            s = int(empty[0])
            fps[i, s], heads[i, s], eids[i, s], hs[i, s] = fp, row, eid, h
            temps[i, s] = temp
            return True
    i = base + int(rng.choice((i1, i2)))
    cur = (np.uint32(fp), np.int32(temp), np.int32(row), np.int32(eid),
           np.uint32(h))
    for _ in range(max_kicks):
        s = int(rng.integers(slots))
        victim = (fps[i, s], temps[i, s], heads[i, s], eids[i, s], hs[i, s])
        fps[i, s], temps[i, s], heads[i, s], eids[i, s], hs[i, s] = cur
        cur = victim
        local = int(hashing.alt_bucket(np.uint32(i - base), cur[0], nb))
        i = base + local
        empty = np.nonzero(fps[i] == hashing.EMPTY_FP)[0]
        if empty.size:
            s = int(empty[0])
            fps[i, s], temps[i, s], heads[i, s], eids[i, s], hs[i, s] = cur
            return True
    return False


def build_bank_from_rows(num_trees: int, row_tree: np.ndarray,
                         row_entity: np.ndarray, row_hash: np.ndarray,
                         csr_offsets: np.ndarray, csr_nodes: np.ndarray,
                         num_buckets=None,
                         slots: int = DEFAULT_SLOTS, seed: int = 0x5EED,
                         bulk: bool = True,
                         max_kicks: int = DEFAULT_MAX_KICKS,
                         load_target: float = DEFAULT_LOAD_TARGET,
                         row_temp: Optional[np.ndarray] = None
                         ) -> FilterBank:
    """Build a bank directly from explicit (tree, entity) rows.

    ``num_buckets``: ``None`` picks per-tree ragged bucket counts
    (``_pick_tree_buckets``); an int forces that uniform NB on every tree
    (kick-chain failure then doubles every tree, preserving uniformity);
    an array pins per-tree counts exactly (failure doubles only the
    failing tree).
    """
    T = max(1, int(num_trees))
    row_tree = np.asarray(row_tree, np.int32)
    row_entity = np.asarray(row_entity, np.int32)
    item_hash = np.asarray(row_hash, np.uint32)
    m = row_tree.shape[0]
    item_row = np.arange(m, dtype=np.int32)
    item_temp = (np.zeros(m, np.int32) if row_temp is None
                 else np.asarray(row_temp, np.int32))

    per_tree = np.bincount(row_tree, minlength=T) if m else \
        np.zeros(T, np.int64)
    uniform = num_buckets is not None and np.ndim(num_buckets) == 0
    if num_buckets is None:
        tree_nb = _pick_tree_buckets(per_tree, slots, load_target)
    elif uniform:
        tree_nb = np.full(T, int(num_buckets), np.int64)
    else:
        tree_nb = np.asarray(num_buckets, np.int64).copy()
    if not ((tree_nb & (tree_nb - 1) == 0).all() and (tree_nb > 0).all()):
        raise ValueError("bucket counts must be powers of two per tree")

    rebuilds = -1
    while True:
        rebuilds += 1
        offsets = np.zeros(T + 1, np.int64)
        np.cumsum(tree_nb, out=offsets[1:])
        a = int(offsets[-1])
        rng = np.random.default_rng(seed)
        fps = np.full((a, slots), hashing.EMPTY_FP, dtype=np.uint32)
        temps = np.zeros((a, slots), dtype=np.int32)
        heads = np.full((a, slots), NULL, dtype=np.int32)
        eids = np.full((a, slots), NULL, dtype=np.int32)
        hs = np.zeros((a, slots), dtype=np.uint32)
        stats = {"items": int(m), "bulk_placed": 0, "evicted": 0,
                 "rebuilds": rebuilds}

        if bulk and m:
            item_mask = (tree_nb[row_tree] - 1).astype(np.uint32)
            fp = hashing.fingerprint(item_hash)
            i1 = hashing.bucket_i1_masked(item_hash, item_mask)
            i2 = hashing.alt_bucket_masked(i1, fp, item_mask)
            base = offsets[row_tree]
            arena_base = np.repeat(offsets[:-1], tree_nb)
            arena_mask = np.repeat((tree_nb - 1).astype(np.uint32),
                                   tree_nb)
            r_head, r_eid, r_hash, r_temp = bulk_place(
                fps, temps, heads, eids, hs, fp,
                base + i1.astype(np.int64), base + i2.astype(np.int64),
                item_row, row_entity, item_hash, nb=0, rng=rng,
                new_temps=item_temp, row_base=arena_base,
                row_mask=arena_mask)
            stats["bulk_placed"] = int(m - r_head.size)
            stats["evicted"] = int(r_head.size)
        else:
            r_head, r_eid, r_hash = item_row, row_entity, item_hash
            r_temp = item_temp

        ok = True
        for j in range(r_head.size):
            # a remainder item's tree is recoverable from its row payload
            tree = int(row_tree[int(r_head[j])])
            if not _scalar_insert(fps, temps, heads, eids, hs,
                                  int(offsets[tree]), int(tree_nb[tree]),
                                  slots, int(r_hash[j]),
                                  int(r_head[j]), int(r_eid[j]), rng,
                                  max_kicks, temp=int(r_temp[j])):
                ok = False
                # tree-local doubling: only the failing tree grows (unless
                # the caller forced a uniform layout)
                if uniform:
                    tree_nb = tree_nb * 2
                else:
                    tree_nb[tree] *= 2
                break
        if ok:
            over = per_tree >= DEFAULT_LOAD_THRESHOLD * tree_nb * slots
            if m == 0 or not over.any():
                break
            if uniform:
                tree_nb = tree_nb * 2
            else:
                tree_nb[over] *= 2

    return FilterBank(
        num_trees=T, tree_nb=tree_nb.astype(np.int32),
        bucket_offsets=offsets, slots=slots,
        fingerprints=fps, temperature=temps,
        heads=heads, entity_ids=eids, stored_hash=hs,
        csr_offsets=np.asarray(csr_offsets, np.int32),
        csr_nodes=np.asarray(csr_nodes, np.int32),
        row_tree=row_tree, row_entity=row_entity,
        num_items=np.bincount(row_tree, minlength=T).astype(np.int32),
        build_stats=stats,
    )


def build_bank(forest: EntityForest, num_buckets=None,
               slots: int = DEFAULT_SLOTS, seed: int = 0x5EED,
               bulk: bool = True, max_kicks: int = DEFAULT_MAX_KICKS,
               load_target: float = DEFAULT_LOAD_TARGET) -> FilterBank:
    """Build the bank for ``forest``.

    ``bulk=True`` (default) is the vectorized path; ``bulk=False`` inserts
    every item through the scalar path.  ``num_buckets=None`` (default)
    sizes every tree independently (ragged arena); an int forces the
    uniform layout.
    """
    row_tree, row_entity, csr_offsets, csr_nodes, entity_hashes = \
        _bank_rows(forest)
    m = row_tree.shape[0]
    item_hash = (entity_hashes[row_entity] if m
                 else np.zeros(0, np.uint32)).astype(np.uint32)
    return build_bank_from_rows(
        max(1, forest.num_trees), row_tree, row_entity, item_hash,
        csr_offsets, csr_nodes, num_buckets=num_buckets, slots=slots,
        seed=seed, bulk=bulk, max_kicks=max_kicks, load_target=load_target)
