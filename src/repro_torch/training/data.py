"""Synthetic data pipeline: deterministic, seekable token streams with
host-side prefetch — stands in for a real corpus loader with identical
interfaces (shard-aware iteration, checkpointable cursor).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-chain synthetic text: next-token depends on current token,
    # giving a learnable (non-uniform) distribution so loss visibly drops.
    markov_concentration: float = 0.2


class SyntheticTokenStream:
    """Seekable deterministic stream of (tokens, labels) batches."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # sparse-ish transition structure over a reduced alphabet for speed
        self.alphabet = min(cfg.vocab, 1024)
        k = 8  # successors per token
        self.successors = rng.integers(
            0, self.alphabet, size=(self.alphabet, k)
        )
        self.step = 0

    def seek(self, step: int) -> None:
        self.step = step

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self.step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.alphabet, size=B)
        choices = rng.integers(0, self.successors.shape[1], size=(B, S))
        for t in range(S):
            toks[:, t + 1] = self.successors[toks[:, t], choices[:, t]]
        self.step += 1
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


class PrefetchLoader:
    """Host-side prefetch thread (depth-bounded), mirroring a production
    input pipeline's overlap of host batch assembly with device steps."""

    def __init__(self, stream: SyntheticTokenStream, depth: int = 2) -> None:
        self.stream = stream
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self.stream.next_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
