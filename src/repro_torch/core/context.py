"""Context Generation (paper Algorithm 3) — the device half.

Given the node locations of a query entity, collect for every node the
first ``n`` upward (ancestors, nearest first) and downward (BFS level
order) entity ids.  The JAX reference states these walks twice, as
scan/fori loops (``core/context.py``) and as static unrolled selects
(``kernels/fused_retrieve/ref.py``), and pins the two bit-identical; the
torch body below is the unrolled form, and serves both.
"""
from __future__ import annotations

import torch

from .lookup import take

NULL = -1


def gather_hierarchy(parent: torch.Tensor, entity_id: torch.Tensor,
                     nodes: torch.Tensor, n: int) -> torch.Tensor:
    """n-level ancestor gather: ``(len(nodes), n)`` ancestor entity ids,
    NULL-padded — the parent-pointer chase as n dependent gathers."""
    cur = nodes.to(torch.int32)
    outs = []
    for _ in range(n):
        p = torch.where(cur == NULL, NULL, take(parent, cur))
        eid = torch.where(p == NULL, NULL, take(entity_id, p))
        outs.append(eid)
        cur = p
    return torch.stack(outs, dim=1) if outs else \
        cur.new_empty((cur.shape[0], 0))


def gather_descendants(child_offsets: torch.Tensor, child_index: torch.Tensor,
                       entity_id: torch.Tensor, nodes: torch.Tensor,
                       n: int) -> torch.Tensor:
    """First-n BFS-down entity ids per node with a bounded frontier
    buffer of n entries (level order, NULL-padded).  A push appends a
    node's children while the buffer has room; step i emits buffer entry
    i and pushes its children."""
    b = nodes.shape[0]
    dev = nodes.device
    nodes = nodes.to(torch.int32)
    buf = torch.full((b, n), NULL, dtype=torch.int32, device=dev)
    w = torch.zeros(b, dtype=torch.int32, device=dev)   # buffer write cursor
    lane = torch.arange(n, dtype=torch.int32, device=dev)[None, :]

    def push(buf, w, src):
        s = src.clamp(min=0)
        lo = take(child_offsets, s)
        hi = take(child_offsets, s + 1)
        for k in range(n):
            idx = lo + k
            valid = (src != NULL) & (idx < hi) & (w < n)
            c = torch.where(valid, take(child_index, idx), NULL)
            oh = (lane == w.clamp(max=n - 1)[:, None]) & valid[:, None]
            buf = torch.where(oh, c[:, None], buf)
            w = torch.where(valid, w + 1, w)
        return buf, w

    buf, w = push(buf, w, nodes)
    out = torch.full((b, n), NULL, dtype=torch.int32, device=dev)
    for i in range(n):
        cur = buf[:, i]
        valid = (i < w) & (cur != NULL)
        out[:, i] = torch.where(valid, take(entity_id, cur), out[:, i])
        buf, w = push(buf, w, torch.where(valid, cur, NULL))
    return out
