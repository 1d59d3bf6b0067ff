"""Improved Cuckoo Filter — the part the filter-bank build needs.

Host side (numpy): the vectorized partial-key cuckoo placement with
random-kick eviction (the paper's Algorithm 1, batched) that
:mod:`repro_torch.core.bank` builds every per-tree filter with.  The
slot constants are the paper's: 4 fingerprints per bucket, 500 kicks
before a filter doubles, expansion past 95% load.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import hashing

NULL = -1
DEFAULT_SLOTS = 4                  # paper: 4 fingerprints per bucket
DEFAULT_MAX_KICKS = 500
DEFAULT_LOAD_THRESHOLD = 0.95      # expand beyond this


def bulk_place(fingerprints: np.ndarray, temperature: np.ndarray,
               heads: np.ndarray, entity_ids: np.ndarray,
               stored_hash: np.ndarray, fp: np.ndarray, b1: np.ndarray,
               b2: np.ndarray, new_heads: np.ndarray, new_eids: np.ndarray,
               new_hashes: np.ndarray, nb: int, rng,
               max_rounds: int = 48,
               new_temps: Optional[np.ndarray] = None,
               row_base: Optional[np.ndarray] = None,
               row_mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, ...]:
    """Vectorized cuckoo placement into flat ``(num_rows, S)`` tables.

    Rows may be a single filter's buckets, a whole uniform filter bank
    flattened to ``tree * NB + bucket``, or a ragged bucket arena — the
    routine only sees row indices.  A victim's alternate bucket is computed
    within its own filter's row range: for the uniform layouts ``nb``
    (per-filter bucket count) locates the range as ``(row // nb) * nb``;
    for a ragged arena the caller passes ``row_base``/``row_mask`` — per
    arena-row segment start and bucket mask ``nb_t - 1`` — and ``nb`` is
    ignored for rehoming.

    Each round: items grouped by candidate bucket claim that bucket's free
    slots by within-group rank (one fancy-indexed write for all of them);
    round 0 survivors retry their second choice; later survivors run a
    vectorized eviction — one leader per bucket swaps with a random victim
    slot, the victim re-enters the pool at its partner bucket (temperature
    rides along) and non-leaders flip to their other bucket.  Returns
    ``(heads, eids, hashes, temps)`` of the items still homeless after
    ``max_rounds`` — the scalar-fallback remainder, ~empty below the
    expansion load threshold.  ``new_temps`` seeds the incoming items'
    temperatures; default 0.
    """
    pool_fp = np.asarray(fp, np.uint32).copy()
    pool_head = np.asarray(new_heads, np.int32).copy()
    pool_eid = np.asarray(new_eids, np.int32).copy()
    pool_hash = np.asarray(new_hashes, np.uint32).copy()
    pool_temp = (np.zeros(pool_fp.shape[0], np.int32) if new_temps is None
                 else np.asarray(new_temps, np.int32).copy())
    bucket = np.asarray(b1, np.int64).copy()
    other = np.asarray(b2, np.int64).copy()
    slots = fingerprints.shape[1]

    for rnd in range(max_rounds):
        if pool_fp.size == 0:
            break
        # ---- empty-slot pass at each item's current candidate bucket
        occupied = fingerprints != hashing.EMPTY_FP            # (rows, S)
        # k-th free slot of each row: stable argsort floats empties first
        free_pos = np.argsort(occupied, axis=1, kind="stable")
        free_cnt = (~occupied).sum(axis=1)
        order = np.argsort(bucket, kind="stable")
        bs = bucket[order]
        starts = np.flatnonzero(np.r_[True, bs[1:] != bs[:-1]])
        run_len = np.diff(np.append(starts, bs.size))
        rank = np.arange(bs.size) - np.repeat(starts, run_len)
        fits = rank < free_cnt[bs]
        rows = bs[fits]
        ss = free_pos[rows, rank[fits]]
        sel = order[fits]
        fingerprints[rows, ss] = pool_fp[sel]
        temperature[rows, ss] = pool_temp[sel]
        heads[rows, ss] = pool_head[sel]
        entity_ids[rows, ss] = pool_eid[sel]
        stored_hash[rows, ss] = pool_hash[sel]
        keep = order[~fits]
        pool_fp, pool_head = pool_fp[keep], pool_head[keep]
        pool_eid, pool_hash = pool_eid[keep], pool_hash[keep]
        pool_temp = pool_temp[keep]
        bucket, other = bucket[keep], other[keep]
        if pool_fp.size == 0:
            break
        if rnd == 0:                   # try every item's second choice once
            bucket, other = other, bucket
            continue
        # ---- vectorized eviction (survivor buckets are provably full)
        order = np.argsort(bucket, kind="stable")
        bs = bucket[order]
        is_lead = np.r_[True, bs[1:] != bs[:-1]]
        lead = order[is_lead]
        lb = bucket[lead]
        s = rng.integers(0, slots, size=lb.size)
        v = (fingerprints[lb, s].copy(), temperature[lb, s].copy(),
             heads[lb, s].copy(), entity_ids[lb, s].copy(),
             stored_hash[lb, s].copy())
        fingerprints[lb, s] = pool_fp[lead]
        temperature[lb, s] = pool_temp[lead]
        heads[lb, s] = pool_head[lead]
        entity_ids[lb, s] = pool_eid[lead]
        stored_hash[lb, s] = pool_hash[lead]
        if row_base is None:
            base = (lb // nb) * nb
            v_other = base + hashing.alt_bucket(
                (lb - base).astype(np.uint32), v[0], nb).astype(np.int64)
        else:
            base = row_base[lb]
            v_other = base + hashing.alt_bucket_masked(
                (lb - base).astype(np.uint32), v[0],
                row_mask[lb]).astype(np.int64)
        waiters = order[~is_lead]
        pool_fp = np.concatenate([pool_fp[waiters], v[0]])
        pool_temp = np.concatenate([pool_temp[waiters], v[1]])
        pool_head = np.concatenate([pool_head[waiters], v[2]])
        pool_eid = np.concatenate([pool_eid[waiters], v[3]])
        pool_hash = np.concatenate([pool_hash[waiters], v[4]])
        bucket, other = (np.concatenate([other[waiters], v_other]),
                         np.concatenate([bucket[waiters], lb]))
    return pool_head, pool_eid, pool_hash, pool_temp
