"""CFT-RAG device retrieval — the paper's method on the card.

A batch of ``(tree_id, hash)`` queries is probed against the ragged
filter-bank arena, hit slots get a temperature bump, and every hit's CSR
row yields a window of tree nodes with their ancestor and descendant
entity ids.  :func:`retrieve_device` runs that step either as a chain of
plain torch ops around a pluggable probe (``lookup_fn``, the CUDA arena
probe on the serving path) or, with ``fused=True``, as one launch of the
fused-retrieve CUDA kernel.

Entry points default to the card: ``device=None`` means CUDA and raises
where there is none.  Callers that want the plain torch path on the CPU
pass ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .bank import FilterBank, pad_csr
from .context import gather_descendants, gather_hierarchy
from .lookup import LookupResult, bump_temperature_arena, lookup_arena, take
from .tree import EntityForest

NULL = -1


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; with no CUDA device that raises instead of
    carrying on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card by default; "
                "pass device='cpu' to run its plain torch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class DeviceRetrieval(NamedTuple):
    hit: torch.Tensor          # (B,) bool
    locations: torch.Tensor    # (B, max_locs) int32 node ids (NULL-padded)
    up: torch.Tensor           # (B, max_locs, n) ancestor entity ids
    down: torch.Tensor         # (B, max_locs, n) descendant entity ids
    temperature: torch.Tensor  # updated (A, S) arena table — thread into state


STATE_FIELDS = ("fingerprints", "temperature", "heads", "bucket_offsets",
                "tree_nb", "csr_offsets", "csr_nodes", "parent", "entity_id",
                "child_offsets", "child_index")


@dataclasses.dataclass
class CFTDeviceState:
    """All retrieval tensors, on one device, all int32.

    Filter tables are a flat **ragged bucket arena** ``(A, S)``: tree
    ``t`` owns arena rows ``[bucket_offsets[t], bucket_offsets[t+1])``
    with its own power-of-two ``tree_nb[t]``.  Slot payloads (``heads``)
    index rows of ``csr_offsets``.  Fingerprints are 12-bit values, so
    their int32 tensor holds the same numbers as the reference's uint32
    table.
    """
    fingerprints: torch.Tensor    # (A, S) — 0 = empty
    temperature: torch.Tensor     # (A, S)
    heads: torch.Tensor           # (A, S) — CSR row id payloads
    bucket_offsets: torch.Tensor  # (T + 1,) — per-tree segment starts
    tree_nb: torch.Tensor         # (T,) — per-tree bucket counts
    csr_offsets: torch.Tensor     # (R + 1,)
    csr_nodes: torch.Tensor       # (L,) — node id per location
    parent: torch.Tensor          # (N,)
    entity_id: torch.Tensor       # (N,)
    child_offsets: torch.Tensor   # (N + 1,)
    child_index: torch.Tensor     # (C,)

    @property
    def num_trees(self) -> int:
        return int(self.bucket_offsets.shape[0]) - 1

    @property
    def device(self) -> torch.device:
        return self.fingerprints.device

    def with_temperature(self, temperature: torch.Tensor) -> "CFTDeviceState":
        """Thread an updated temperature table back into the state."""
        return dataclasses.replace(self, temperature=temperature)

    @classmethod
    def from_arrays(cls, fields: Dict[str, np.ndarray],
                    device=None) -> "CFTDeviceState":
        """State from the eleven host arrays (the reference's state fields
        as ``jax.device_get`` returns them).  Every array is copied, so
        later host writes never show through the state."""
        dev = resolve_device(device)
        out = {}
        for name in STATE_FIELDS:
            a = np.asarray(fields[name])
            if a.dtype.kind not in "iu":
                raise TypeError(f"{name}: integer array expected, "
                                f"got {a.dtype}")
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            out[name] = torch.tensor(a.astype(np.int32, copy=False),
                                     device=dev)
        return cls(**out)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The eleven fields as host arrays in the reference's dtypes
        (``fingerprints`` uint32, the rest int32)."""
        out = {n: getattr(self, n).cpu().numpy().copy()
               for n in STATE_FIELDS}
        out["fingerprints"] = out["fingerprints"].view(np.uint32)
        return out

    @classmethod
    def from_bank(cls, bank: FilterBank, forest: EntityForest,
                  device=None) -> "CFTDeviceState":
        # pad_csr keeps the CSR shapes stable as the arena grows
        csr_off, csr_nodes = pad_csr(bank.csr_offsets, bank.csr_nodes)
        one = np.zeros(1, np.int32)
        return cls.from_arrays(dict(
            fingerprints=bank.fingerprints,
            temperature=bank.temperature,
            heads=bank.heads,
            bucket_offsets=bank.bucket_offsets.astype(np.int32),
            tree_nb=bank.tree_nb.astype(np.int32),
            csr_offsets=csr_off, csr_nodes=csr_nodes,
            parent=forest.parent if forest.num_nodes else one,
            entity_id=forest.entity_id if forest.num_nodes else one,
            child_offsets=forest.child_offsets,
            child_index=(forest.child_index if forest.child_index.size
                         else one)), device)


def retrieve_device(state: CFTDeviceState, query_hashes: torch.Tensor,
                    query_trees: Optional[torch.Tensor] = None,
                    max_locs: int = 4, n: int = 3,
                    lookup_fn=None, fused: bool = False) -> DeviceRetrieval:
    """Batched CFT-RAG retrieval over ``(tree_id, hash)`` queries.

    ``query_hashes`` hold uint32 values (int64 tensors, or int32 bit
    patterns); ``query_trees`` defaults to all zeros.  Out-of-range tree
    ids miss.  ``lookup_fn(fingerprints, heads, row_offsets, masks, h)``
    probes the arena — :func:`repro_torch.core.lookup.lookup_arena` by
    default; the serving pipeline passes the CUDA arena probe.

    ``fused=True`` runs the whole step (probe + bump + CSR window +
    hierarchy walks) as one launch of the fused-retrieve kernel —
    bit-identical outputs.  Mutually exclusive with ``lookup_fn``.
    """
    if fused:
        if lookup_fn is not None:
            raise ValueError("fused=True embeds the probe; lookup_fn "
                             "cannot be combined with it")
        from ..kernels.fused_retrieve.ops import fused_retrieve_state_auto
        return fused_retrieve_state_auto(state, query_hashes, query_trees,
                                         max_locs=max_locs, n=n)
    if lookup_fn is None:
        lookup_fn = lookup_arena
    if query_trees is None:
        query_trees = torch.zeros(query_hashes.shape, dtype=torch.int32,
                                  device=query_hashes.device)
    # out-of-range tree ids must miss, not alias to a clamped gather row
    in_range = (query_trees >= 0) & (query_trees < state.num_trees)
    query_trees = torch.where(in_range, query_trees, 0)
    row_off = take(state.bucket_offsets, query_trees)
    masks = take(state.tree_nb, query_trees) - 1
    res: LookupResult = lookup_fn(state.fingerprints, state.heads,
                                  row_off, masks, query_hashes)
    res = res._replace(hit=res.hit & in_range)
    temp = bump_temperature_arena(state.temperature, row_off, res)
    return gather_context(state, res, temp, max_locs=max_locs, n=n)


def gather_context(state, res: LookupResult, temperature: torch.Tensor,
                   max_locs: int = 4, n: int = 3) -> DeviceRetrieval:
    """CSR location gather + hierarchy windows downstream of a lookup."""
    nodes = csr_window(state.csr_offsets, state.csr_nodes,
                       res.hit, res.head, max_locs)
    return finish_context(state, res.hit, nodes, temperature, n=n)


def csr_window(csr_offsets: torch.Tensor, csr_nodes: torch.Tensor,
               hit: torch.Tensor, head: torch.Tensor,
               max_locs: int) -> torch.Tensor:
    """Per-query CSR location window ``(B, max_locs)``, NULL-padded.

    Misses route to the *empty sentinel row* ``R = len(csr_offsets) - 1``,
    whose window ``[terminal, terminal)`` is empty by construction.
    """
    r = csr_offsets.shape[0] - 1
    eid = torch.where(hit, head, r).clamp(0, r)                # (B,) rows
    lo = take(csr_offsets, eid)
    count = take(csr_offsets, (eid + 1).clamp(max=r)) - lo
    k = torch.arange(max_locs, dtype=torch.int32, device=hit.device)
    idx = lo[:, None] + k[None, :]
    valid = (k[None, :] < count[:, None]) & hit[:, None]
    return torch.where(valid, take(csr_nodes, idx), NULL)      # (B, max_locs)


def hierarchy_windows(parent: torch.Tensor, entity_id: torch.Tensor,
                      child_offsets: torch.Tensor, child_index: torch.Tensor,
                      nodes: torch.Tensor, n: int):
    """``(up, down)`` entity-id windows of shape ``nodes.shape + (n,)``;
    a NULL node yields NULL rows."""
    flat = nodes.reshape(-1)
    src = flat.clamp(min=0)
    up = gather_hierarchy(parent, entity_id, src, n)
    down = gather_descendants(child_offsets, child_index, entity_id, src, n)
    null = flat[:, None] == NULL
    shape = (*nodes.shape, n)
    return (torch.where(null, NULL, up).reshape(shape),
            torch.where(null, NULL, down).reshape(shape))


def finish_context(state, hit: torch.Tensor, nodes: torch.Tensor,
                   temperature: torch.Tensor, n: int = 3) -> DeviceRetrieval:
    """Hierarchy windows for an already-gathered location window."""
    up, down = hierarchy_windows(state.parent, state.entity_id,
                                 state.child_offsets, state.child_index,
                                 nodes, n)
    return DeviceRetrieval(hit=hit, locations=nodes, up=up, down=down,
                           temperature=temperature)
