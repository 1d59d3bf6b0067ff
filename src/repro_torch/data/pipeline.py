"""Host data pipeline: documents -> packed token batches, checkpointable.

A copy of the reference's (pure Python and numpy); batches stay numpy
arrays, and the caller moves them to its device.

Design points that matter at pod scale:
* deterministic **host sharding** — host h of H receives documents h::H, so
  the global batch is reproducible for any host count (elastic restarts);
* **packing** — documents are concatenated with EOS separators and cut into
  fixed seq_len windows (no padding waste);
* **stateful iteration** — (epoch, cursor) travels with the training
  checkpoint, so a preempted job resumes mid-epoch without replaying data;
* **prefetch** — a one-slot background thread keeps the next batch ready
  while the step runs (host-compute / device-compute overlap).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .tokenizer import HashTokenizer


@dataclasses.dataclass
class PipelineState:
    epoch: int = 0
    cursor: int = 0          # token offset within the epoch's stream

    def as_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


class TextDataset:
    """Tokenized, host-sharded document stream."""

    def __init__(self, documents: Sequence[str], tokenizer: HashTokenizer,
                 host_id: int = 0, num_hosts: int = 1, seed: int = 0):
        self.tokenizer = tokenizer
        self.seed = seed
        self._docs = list(documents[host_id::num_hosts])
        if not self._docs:
            self._docs = ["empty shard"]

    def epoch_tokens(self, epoch: int) -> np.ndarray:
        """The epoch's full token stream (shuffled doc order, EOS-joined)."""
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(len(self._docs))
        ids: List[int] = []
        for di in order:
            ids.extend(self.tokenizer.encode(self._docs[di], bos=True,
                                             eos=True))
        return np.asarray(ids, dtype=np.int32)


class PackedBatches:
    """Iterator of {tokens, labels, mask} packed LM batches."""

    def __init__(self, dataset: TextDataset, batch_size: int, seq_len: int,
                 state: Optional[PipelineState] = None,
                 prefetch: bool = True):
        self.ds = dataset
        self.batch = batch_size
        self.seq = seq_len
        self.state = state or PipelineState()
        self._stream = self.ds.epoch_tokens(self.state.epoch)
        self._prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ batching
    def _next_window(self) -> np.ndarray:
        need = self.batch * (self.seq + 1)
        while self.state.cursor + need > self._stream.shape[0]:
            self.state = PipelineState(epoch=self.state.epoch + 1, cursor=0)
            self._stream = self.ds.epoch_tokens(self.state.epoch)
            if self._stream.shape[0] < need:     # tiny corpora: tile up
                reps = need // max(1, self._stream.shape[0]) + 1
                self._stream = np.tile(self._stream, reps)
        w = self._stream[self.state.cursor:self.state.cursor + need]
        self.state.cursor += need
        return w.reshape(self.batch, self.seq + 1)

    def next_batch(self) -> dict:
        w = self._next_window()
        return {
            "tokens": w[:, :-1].astype(np.int32),
            "labels": w[:, 1:].astype(np.int32),
            "mask": (w[:, 1:] != HashTokenizer.PAD).astype(np.float32),
        }

    # ------------------------------------------------------------ prefetch
    def _worker(self):
        while True:
            item = self.next_batch()
            self._q.put(item)        # blocks when the slot is full

    def __iter__(self) -> Iterator[dict]:
        if not self._prefetch:
            while True:
                yield self.next_batch()
        self._q = queue.Queue(maxsize=1)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        while True:
            yield self._q.get()

    # ------------------------------------------------------- checkpointing
    def checkpoint_state(self) -> dict:
        return self.state.as_dict()

    def restore_state(self, d: dict) -> None:
        self.state = PipelineState.from_dict(d)
        self._stream = self.ds.epoch_tokens(self.state.epoch)
