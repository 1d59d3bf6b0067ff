"""Retrieval session: the enqueue-able retrieval unit behind serving.

Owns the device state, the retrieval step, the padding policy and
temperature threading.  The step is plain eager torch around the CUDA
kernels: the arena probe as ``lookup_fn`` on the unfused chain, or the
fused-retrieve kernel with ``fused=True``.  Host maintenance (the
reference's two-phase restage, tenants, snapshots, tracing) is not part
of this port yet, so :meth:`RetrievalSession.harvest` absorbs nothing.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.trag import DeviceRetrieval, retrieve_device


class RetrievalSession:
    """Pad, dispatch and thread temperature for ``(tree_id, hash)``
    query batches against one :class:`~repro_torch.core.CFTDeviceState`.

    The hot path splits into dispatch and harvest so a scheduler can
    overlap host work with the in-flight device batch:

    * :meth:`pad_queries` — shape-stable padding to a multiple of
      ``batch_pad`` (or a caller-picked ``pad_to``);
    * :meth:`retrieve_dispatch` — run the step and thread the bumped
      temperature into the live state without a device sync;
    * :meth:`harvest` — absorb device temperature into a host bank (no
      host bank is attached in this port: returns 0).
    """

    def __init__(self):
        self.state = None
        self.batch_pad = 64
        self.fused = False
        self._step = None
        self._attach_args = (None, 4, 3)

    def attach(self, state, lookup_fn=None, max_locs: int = 4, n: int = 3,
               batch_pad: int = 64, fused: bool = False) -> None:
        """Point the session at a device state.  ``fused=True`` serves
        through the single-pass fused-retrieve kernel; it is mutually
        exclusive with ``lookup_fn`` (the fused kernel *is* the probe).
        Flip at runtime with :meth:`set_fused`."""
        if fused and lookup_fn is not None:
            raise ValueError("fused=True embeds the probe; lookup_fn "
                             "cannot be combined with it")
        self.state = state
        self.batch_pad = batch_pad
        self.fused = bool(fused)
        self._attach_args = (lookup_fn, max_locs, n)
        self._build_step()

    def _build_step(self) -> None:
        lookup_fn, max_locs, n = self._attach_args
        self._step = functools.partial(
            retrieve_device, max_locs=max_locs, n=n, lookup_fn=lookup_fn,
            fused=self.fused)

    def set_fused(self, on: bool) -> None:
        """Flip the attached step between the fused single-pass kernel
        and the unfused chain at runtime."""
        if self.state is None:
            raise RuntimeError("attach a retrieval state first")
        if bool(on) == self.fused:
            return
        lookup_fn, _, _ = self._attach_args
        if on and lookup_fn is not None:
            raise ValueError("fused=True embeds the probe; lookup_fn "
                             "cannot be combined with it")
        self.fused = bool(on)
        self._build_step()

    # ---------------------------------------------------------- hot path
    def pad_queries(self, tree_ids: Sequence[int], hashes: Sequence[int],
                    pad_to: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Pad a query batch to a shape-stable geometry; returns
        ``(hashes int64, tree_ids int32, true_length)`` on the state's
        device.  Default policy rounds up to a multiple of ``batch_pad``.
        Pad slots are *valid* queries of tree 0 with hash 0: a pad hash
        can in principle alias a stored fingerprint, which only
        over-bumps that slot's temperature — a heuristic, not a
        correctness input."""
        b = len(hashes)
        bp = pad_to if pad_to is not None else \
            max(self.batch_pad, -(-b // self.batch_pad) * self.batch_pad)
        if bp < b:
            raise ValueError(f"pad_to {bp} < batch {b}")
        tid = np.zeros((bp,), np.int32)
        tid[:b] = np.asarray(tree_ids, np.int32)
        hh = np.zeros((bp,), np.int64)
        hh[:b] = np.asarray(hashes, np.uint32)
        dev = self.state.device
        return (torch.from_numpy(hh).to(dev), torch.from_numpy(tid).to(dev),
                b)

    def retrieve_dispatch(self, hh: torch.Tensor, tid: torch.Tensor
                          ) -> DeviceRetrieval:
        """Run one already-padded retrieval step and thread the bumped
        temperature into the live state.  Returns the padded result
        without waiting for the device."""
        if self.state is None:
            raise RuntimeError("attach a retrieval state first")
        out = self._step(self.state, hh, tid)
        self.state = self.state.with_temperature(out.temperature)
        return out

    def harvest(self) -> int:
        """Absorb this batch's bumps into the host bank.  No host bank is
        attached in this port (maintenance is not ported yet), so there is
        nothing to absorb: returns 0."""
        return 0

    def retrieve(self, tree_ids: Sequence[int],
                 hashes: Sequence[int]) -> DeviceRetrieval:
        """Serve one ``(tree_id, hash)`` query batch synchronously: pad,
        dispatch, harvest, slice back to the true batch."""
        hh, tid, b = self.pad_queries(tree_ids, hashes)
        out = self.retrieve_dispatch(hh, tid)
        self.harvest()
        return DeviceRetrieval(hit=out.hit[:b], locations=out.locations[:b],
                               up=out.up[:b], down=out.down[:b],
                               temperature=out.temperature)
