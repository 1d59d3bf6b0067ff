"""Serving: the retrieval session and the generation engine.

:class:`RetrievalSession` owns the device state, the retrieval step, the
padding policy and temperature threading.  The step is plain eager torch
around the CUDA kernels: the arena probe as ``lookup_fn`` on the unfused
chain, or the fused-retrieve kernel with ``fused=True``.  Host
maintenance (the reference's two-phase restage, tenants, snapshots,
tracing) is not part of this port yet (ROADMAP Queue 1 items 6-7), so
:meth:`RetrievalSession.harvest` absorbs nothing.

:class:`ServeEngine` is the generation half of the reference's engine:
greedy prefill + decode over fixed-size, left-padded batches.  PyTorch
runs eagerly, so there is no jit; the decode step writes its k/v into the
preallocated cache in place (the reference donates the buffer), and the
new tokens stay on the device until the batch ends.  Its maintenance
hooks wait for item 6.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.trag import DeviceRetrieval, retrieve_device
from ..data.tokenizer import HashTokenizer
from ..models import lm


@dataclasses.dataclass
class Request:
    prompt_ids: List[int]
    max_new_tokens: int = 16
    out_ids: Optional[List[int]] = None


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


class ServeEngine:
    """Greedy generation over fixed batches of ``batch_size`` rows with a
    ``cache_size``-row KV cache, on the device that holds ``params``."""

    def __init__(self, cfg: ModelConfig, params, cache_size: int = 512,
                 batch_size: int = 4):
        self.cfg = cfg
        self.params = params
        self.cache_size = cache_size
        self.batch_size = batch_size
        self.device = params["embed"].device
        self.retrieval = RetrievalSession()

    # ---------------------------------------------------------- retrieval
    def attach_retrieval(self, state, lookup_fn=None, max_locs: int = 4,
                         n: int = 3, batch_pad: int = 64,
                         fused: bool = False) -> None:
        """Fuse CFT retrieval into the engine — see
        :meth:`RetrievalSession.attach`."""
        self.retrieval.attach(state, lookup_fn=lookup_fn,
                              max_locs=max_locs, n=n, batch_pad=batch_pad,
                              fused=fused)

    def retrieve(self, tree_ids: Sequence[int],
                 hashes: Sequence[int]) -> DeviceRetrieval:
        """Serve one ``(tree_id, hash)`` query batch."""
        return self.retrieval.retrieve(tree_ids, hashes)

    # ----------------------------------------------------------- generate
    @torch.inference_mode()
    def generate(self, batch: Dict[str, torch.Tensor],
                 max_new_tokens: int) -> np.ndarray:
        """Greedy generation. batch['tokens']: (B, S) prompt ids.
        Returns the new ids (B, max_new_tokens)."""
        tokens = batch["tokens"].to(self.device)
        logits, state = lm.prefill(self.cfg, self.params, {"tokens": tokens},
                                   self.cache_size)
        tok = lm.greedy_token(logits)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, state = lm.decode_step(self.cfg, self.params, tok, state)
            tok = lm.greedy_token(logits)
            out.append(tok)
        return torch.cat(out, dim=1).cpu().numpy()

    # ---------------------------------------------------------- scheduler
    def pack(self, group: Sequence[Request]) -> Tuple[np.ndarray, int]:
        """One batch of at most ``batch_size`` requests as the prompt
        token array ``(batch_size, max_len)`` and its ``max_new``: each
        prompt truncated to its tail so that it and the new tokens fit
        the cache, then left-padded with ``PAD`` to align the last
        token; unused rows are all ``PAD``."""
        max_new = max(r.max_new_tokens for r in group)
        budget = self.cache_size - max_new
        for r in group:
            if len(r.prompt_ids) > budget:
                r.prompt_ids = r.prompt_ids[-budget:]
        max_len = max(len(r.prompt_ids) for r in group)
        toks = np.full((self.batch_size, max_len), HashTokenizer.PAD,
                       np.int32)
        for i, r in enumerate(group):
            toks[i, max_len - len(r.prompt_ids):] = r.prompt_ids
        return toks, max_new

    def serve(self, requests: Sequence[Request]) -> List[Request]:
        """Continuous-lite: group requests into fixed batches, pad, run."""
        pending = list(requests)
        done: List[Request] = []
        while pending:
            group = pending[:self.batch_size]
            pending = pending[self.batch_size:]
            toks, max_new = self.pack(group)
            out = self.generate({"tokens": torch.from_numpy(toks)}, max_new)
            for i, r in enumerate(group):
                r.out_ids = out[i, :r.max_new_tokens].tolist()
                done.append(r)
        return done


def kv_cache_bytes(cfg: ModelConfig, batch: int, cache_size: int) -> int:
    """Bytes of the dense decoder's KV cache."""
    bpe = 2 if cfg.dtype == "bfloat16" else 4
    return (2 * cfg.n_layers * batch * cfg.n_kv_heads * cache_size
            * cfg.resolved_head_dim * bpe)
