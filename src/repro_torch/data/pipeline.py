"""Data pipeline: deterministic, host-sharded, prefetched.

Sources:
* ``SyntheticCorpus`` — a fixed-seed byte-level Markov "language" with
  enough structure for small models to learn (loss drops well below the
  unigram entropy) — the container has no external datasets.
* ``MemmapCorpus`` — flat token file on disk (np.memmap), the shape a
  production loader reads (one file shard per host in real clusters).

``ShardedLoader`` yields ``{tokens: [B, S+1]}`` batches: deterministic
per (seed, step, host), disjoint across hosts, with a background
prefetch thread so host compute overlaps batch assembly.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticCorpus:
    """Multi-domain byte-level Markov "language".

    ``domains`` distinct order-1 chains (own transitions + emission maps)
    stand in for topic/domain diversity: each *sequence* is drawn from
    one domain, so FF neurons specialize per domain — which is exactly
    the regime the paper studies (flocking within a sequence, low top-k
    overlap between sequences, static pruning fails, GRIFFIN adapts).
    """

    def __init__(self, vocab: int = 256, seed: int = 0, states: int = 32,
                 domains: int = 8):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.states = states
        self.domains = domains
        trans = rng.random((domains, states, states)) ** 8
        self.trans = trans / trans.sum(-1, keepdims=True)
        self.cum = np.cumsum(self.trans, axis=-1)
        self.emit = rng.integers(0, vocab, size=(domains, states))

    def sample(self, n: int, seed: int, domain: Optional[int] = None) -> np.ndarray:
        rng = np.random.default_rng(seed)
        d = int(rng.integers(self.domains)) if domain is None else domain % self.domains
        s = int(rng.integers(self.states))
        out = np.empty(n, np.int32)
        us = rng.random(n)
        cum = self.cum[d]
        emit = self.emit[d]
        for i in range(n):
            s = min(int(np.searchsorted(cum[s], us[i])), self.states - 1)
            out[i] = emit[s]
        return out


class MemmapCorpus:
    """Flat int32 token file; the on-disk shape of a production corpus."""

    def __init__(self, path: str):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")

    def __len__(self) -> int:
        return len(self.tokens)

    def window(self, start: int, n: int) -> np.ndarray:
        start = start % max(len(self.tokens) - n, 1)
        return np.asarray(self.tokens[start : start + n], np.int32)


def write_memmap_corpus(path: str, tokens: np.ndarray) -> None:
    np.asarray(tokens, np.int32).tofile(path)


class ShardedLoader:
    """Deterministic host-sharded batch stream with prefetch."""

    def __init__(
        self,
        corpus,
        batch: int,
        seq_len: int,
        seed: int = 0,
        host_id: int = 0,
        n_hosts: int = 1,
        prefetch: int = 2,
        start_step: int = 0,
    ):
        self.corpus = corpus
        self.batch, self.seq_len = batch, seq_len
        self.seed, self.host_id, self.n_hosts = seed, host_id, n_hosts
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make_batch(self, step: int) -> Dict[str, np.ndarray]:
        n = self.seq_len + 1
        toks = np.empty((self.batch, n), np.int32)
        for b in range(self.batch):
            # unique stream per (seed, step, host, row) — deterministic resume
            s = hash((self.seed, step, self.host_id, b)) % (2**31)
            if isinstance(self.corpus, SyntheticCorpus):
                toks[b] = self.corpus.sample(n, s)
            else:
                toks[b] = self.corpus.window(s, n)
        return {"tokens": toks}

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._make_batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
