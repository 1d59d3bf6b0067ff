"""Batched cuckoo-filter lookup — plain torch semantics.

The vectorized form of the paper's lookup (§3.4): all query hashes are
probed at once.  The CUDA arena probe in
:mod:`repro_torch.kernels.cuckoo_lookup` computes the same hit/head (and
bucket/slot on hits) and is held against this module.

Slot priority matches the paper's linear bucket scan: bucket i1 slots
0..S-1, then bucket i2 slots 0..S-1.

Index tensors are clamped into their table before every gather, which is
what the JAX reference's gathers do on their own (torch raises instead);
on well-formed states no index ever needs the clamp.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import hashing


class LookupResult(NamedTuple):
    hit: torch.Tensor     # (B,) bool
    head: torch.Tensor    # (B,) int32 — CSR row id payload (NULL=-1)
    bucket: torch.Tensor  # (B,) int32 — tree-local bucket of the match
    slot: torch.Tensor    # (B,) int32 — slot within that bucket


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along dim 0 with ``idx`` clamped into range."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def match_rows(fp: torch.Tensor, i1: torch.Tensor, i2: torch.Tensor,
               rows1: torch.Tensor, rows2: torch.Tensor,
               heads1: torch.Tensor, heads2: torch.Tensor,
               s: int) -> LookupResult:
    """Slot-priority match over two gathered bucket rows.  The first
    match is ``min(where(match, pos, 2S))``; a miss reports bucket i1 and
    slot 0, as the reference's argmax over an all-False row does."""
    match = torch.cat([rows1 == fp[:, None], rows2 == fp[:, None]], dim=1)
    pos = torch.arange(2 * s, dtype=torch.int64, device=fp.device)
    first = torch.where(match, pos, 2 * s).amin(dim=1)
    hit = first < 2 * s
    first = torch.where(hit, first, 0)
    bucket = torch.where(first < s, i1, i2).to(torch.int32)
    slot = torch.where(first < s, first, first - s).to(torch.int32)
    heads_cat = torch.cat([heads1, heads2], dim=1)
    head = torch.where(hit, heads_cat.gather(1, first[:, None])[:, 0], -1)
    return LookupResult(hit=hit, head=head.to(torch.int32),
                        bucket=bucket, slot=slot)


def lookup_arena(fingerprints: torch.Tensor, heads: torch.Tensor,
                 row_offsets: torch.Tensor, masks: torch.Tensor,
                 h: torch.Tensor) -> LookupResult:
    """Probe a flat ragged bucket arena with pre-routed per-query segments.

    fingerprints/heads: (A, S) arena tables; ``row_offsets``/``masks``:
    (B,) per-query segment start and bucket mask ``nb_t - 1``; ``h``: (B,)
    hashes (any integer dtype, read as uint32).  ``bucket`` is the
    tree-local bucket index.
    """
    s = fingerprints.shape[-1]
    fp, i1, i2 = hashing.candidate_buckets_masked(h, masks)
    base = row_offsets.to(torch.int64)
    r1, r2 = base + i1, base + i2
    return match_rows(fp, i1, i2, take(fingerprints, r1),
                      take(fingerprints, r2), take(heads, r1),
                      take(heads, r2), s)


def lookup_batch_ragged(fingerprints: torch.Tensor, heads: torch.Tensor,
                        bucket_offsets: torch.Tensor, tree_nb: torch.Tensor,
                        tree_ids: torch.Tensor, h: torch.Tensor
                        ) -> LookupResult:
    """Per-query tree routing over the ragged bucket arena: the probe
    computes ``bucket_offsets[t] + (i & (tree_nb[t] - 1))``."""
    return lookup_arena(fingerprints, heads, take(bucket_offsets, tree_ids),
                        take(tree_nb, tree_ids) - 1, h)


def bump_temperature_arena(temperature: torch.Tensor,
                           row_offsets: torch.Tensor,
                           res: LookupResult) -> torch.Tensor:
    """Algorithm 3's ``temperature += 1`` for every hit slot, on a copy:
    the hit slot lives at arena row ``row_offsets + bucket``.  Duplicate
    ``(row, slot)`` hits in one batch add up (accumulating scatter), as
    the reference's functional scatter-add does."""
    rows = row_offsets.to(torch.int64) + res.bucket.to(torch.int64)
    out = temperature.clone()
    out.index_put_((rows, res.slot.to(torch.int64)),
                   res.hit.to(temperature.dtype), accumulate=True)
    return out
