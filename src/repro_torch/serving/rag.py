"""End-to-end CFT-RAG serving pipeline (paper Figure 1), bank mode.

query -> entity recognition (NER stub) -> per-tree cuckoo-filter probe on
the card (the CUDA arena probe) -> CSR location window -> hierarchical
context (Algorithm 3) -> prompt assembly ``[system | context | query]``
-> generator prefill + greedy decode (:class:`ServeEngine`, through the
flash-attention and decode-attention kernels when its config asks for
``attn_impl="flash"``).

Only the filter-bank device path is ported.  The reference's other modes
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import hashing
from ..core.bank import build_bank
from ..core.trag import CFTDeviceState, retrieve_device
from ..core.tree import build_forest
from ..data.datasets import SyntheticCorpus
from ..data.ner import build_gazetteer, recognize_entities
from ..data.tokenizer import HashTokenizer
from ..kernels.cuckoo_lookup.ops import cuckoo_lookup_arena_auto
from .engine import Request, RetrievalSession, ServeEngine

SYSTEM_PROMPT = ("You are an assistant answering questions about an "
                 "organization using its entity hierarchy.")


@dataclasses.dataclass
class RAGAnswer:
    query: str
    entities: List[str]
    context: str
    prompt: str
    output_ids: Optional[List[int]] = None
    text: Optional[str] = None


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"RAGPipeline({what}) is not ported to repro_torch yet "
        f"(ROADMAP Queue 1 item {item})")


class RAGPipeline:
    """Bank-mode pipeline over a synthetic corpus, with an optional
    generator ``engine`` for :meth:`answer`.

    ``device=None`` puts the filter bank's device state on the card (and
    raises without one); ``device="cpu"`` runs the plain torch path.  The
    engine computes on the device of its own parameters.
    """

    def __init__(self, corpus: SyntheticCorpus,
                 engine: Optional[ServeEngine] = None, *,
                 use_bank: bool = False, mesh=None,
                 snapshot_dir: Optional[str] = None, tenants=None,
                 device=None):
        if not use_bank:
            raise _not_ported("use_bank=False: host CFTRAG / from_index "
                              "device path", "4")
        if mesh is not None:
            raise _not_ported("mesh=...", "9")
        if snapshot_dir is not None:
            raise _not_ported("snapshot_dir=...", "7")
        if tenants is not None:
            raise _not_ported("tenants=...", "7")
        self.corpus = corpus
        self.engine = engine
        self.tokenizer = HashTokenizer(engine.cfg.vocab if engine else 64000)
        self.forest = build_forest(corpus.trees)
        self.gazetteer = build_gazetteer(self.forest.entity_names)
        self.bank = build_bank(self.forest)
        self.session = RetrievalSession()
        self.session.attach(
            CFTDeviceState.from_bank(self.bank, self.forest, device=device),
            lookup_fn=cuckoo_lookup_arena_auto)

    @property
    def _dev_state(self):
        return self.session.state

    @_dev_state.setter
    def _dev_state(self, state) -> None:
        self.session.state = state

    # ---------------------------------------------------------- retrieval
    def retrieve(self, query: str,
                 tree_scope: Optional[int] = None) -> RAGAnswer:
        """Recognize entities and retrieve their hierarchical context.

        ``tree_scope`` routes the whole query batch to one tree of the
        filter bank; ``None`` retrieves globally — each entity fans out
        to every tree.
        """
        ents = recognize_entities(query, self.gazetteer)
        trees_np, hashes_np, b = self._device_query_batch(ents, tree_scope)
        dev = self._dev_state.device
        out = retrieve_device(
            self._dev_state,
            torch.from_numpy(hashes_np.astype(np.int64)).to(dev),
            torch.from_numpy(trees_np).to(dev),
            lookup_fn=cuckoo_lookup_arena_auto)
        self._dev_state = self._dev_state.with_temperature(out.temperature)
        self.session.harvest()
        up, down = self._merge_bank_updown(out.up.cpu().numpy(),
                                           out.down.cpu().numpy(),
                                           b, tree_scope)
        ctxs = self._render_device(ents, up, down)
        prompt = f"{SYSTEM_PROMPT}\n{ctxs}\nQuestion: {query}\nAnswer:"
        return RAGAnswer(query=query, entities=ents, context=ctxs,
                         prompt=prompt)

    def _device_query_batch(self, ents: Sequence[str],
                            tree_scope: Optional[int] = None):
        """Map recognized entities to the ``(tree_ids, hashes)`` batch the
        device step consumes.  With no scope each entity fans out to every
        tree (per-entity results merge back in
        :meth:`_merge_bank_updown`)."""
        hashes = np.asarray(hashing.hash_entities(ents) if ents
                            else np.zeros((1,), np.uint32))
        b = hashes.shape[0]
        if tree_scope is not None:
            trees = np.full((b,), tree_scope, np.int32)
        else:
            t = self.bank.num_trees
            trees = np.repeat(np.arange(t, dtype=np.int32), b)
            hashes = np.tile(hashes, t)
        return trees, hashes, b

    def _merge_bank_updown(self, up: np.ndarray, down: np.ndarray, b: int,
                           tree_scope: Optional[int]):
        """Fold the per-tree fan-out back to per-entity rows: the
        ``(t*b, locs, n)`` device result regroups as ``(b, t*locs, n)``."""
        if tree_scope is None:
            t, locs, n = self.bank.num_trees, up.shape[1], up.shape[2]
            up = (up.reshape(t, b, locs, n).transpose(1, 0, 2, 3)
                    .reshape(b, t * locs, n))
            down = (down.reshape(t, b, locs, n).transpose(1, 0, 2, 3)
                      .reshape(b, t * locs, n))
        return up, down

    def _render_device(self, ents: Sequence[str], up_arr: np.ndarray,
                       down_arr: np.ndarray) -> str:
        lines = []
        names = self.forest.entity_names
        for i, e in enumerate(ents):
            ups = [names[int(u)] for u in up_arr[i].ravel() if int(u) >= 0]
            downs = [names[int(d)] for d in down_arr[i].ravel()
                     if int(d) >= 0]
            if ups:
                lines.append(f"The upward hierarchical relationship of {e} "
                             f"are: {', '.join(dict.fromkeys(ups))}.")
            if downs:
                lines.append(f"The downward hierarchical relationship of {e} "
                             f"are: {', '.join(dict.fromkeys(downs))}.")
        return "\n".join(lines)

    # ----------------------------------------------------------- generate
    def answer(self, query: str, max_new_tokens: int = 16) -> RAGAnswer:
        """Retrieve, build the prompt, and generate greedily with the
        engine; fills ``output_ids`` and ``text`` (without an engine,
        returns the retrieval alone)."""
        ans = self.retrieve(query)
        if self.engine is None:
            return ans
        ids = self.tokenizer.encode(ans.prompt, bos=True)
        req = Request(prompt_ids=ids, max_new_tokens=max_new_tokens)
        self.engine.serve([req])
        ans.output_ids = req.out_ids
        ans.text = self.tokenizer.decode(req.out_ids)
        # The reference ends with self.maintain(): with no pending deltas it
        # only harvests temperature and resorts hot slots, which changes no
        # later answer's context, prompt or ids.  Maintenance is ROADMAP
        # Queue 1 item 6; until it is ported, answer() ends here.
        return ans
