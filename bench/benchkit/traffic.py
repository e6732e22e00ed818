"""One generator for every traffic mix: a mix is a data file of
parameters (``bench/traffic/<mix>.json``), and its requests are a pure
function of (mix, seed, vocabulary).

Every seed gets the same work in another order: requests come in blocks
of ``block``; in each block the prompt lengths are the same ``block``
evenly spaced points of the mix's range, and (with a pool of documents)
each document is chosen equally often, both permuted by the seed. Token
ids are uniform over the vocabulary.

Keys a mix may hold: ``prompt_tokens`` [lo, hi] (fresh prompts), or
``doc_tokens`` with ``docs`` (a pool of that many documents, or
``"fresh"``: a new document each request) and ``question_tokens`` [lo,
hi] (a fresh question after the document); ``new_tokens``; ``block``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

_DOCS = 1 << 40          # SeedSequence words that keep the streams apart
_FRESH = 1 << 41


def _even(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths spread evenly over [lo, hi]."""
    k = np.arange(n)
    return lo + ((k + 0.5) * (hi - lo + 1) / n).astype(np.int64)


class Traffic:
    def __init__(self, mix: Dict, seed: int, vocab: int) -> None:
        self.mix = mix
        self.seed = int(seed) % (1 << 64)
        self.vocab = int(vocab)
        self.block = int(mix.get("block", 64))
        self.new_tokens = int(mix.get("new_tokens", 1))
        self._blocks: Dict[int, Dict] = {}
        self.docs: List[np.ndarray] = []
        if isinstance(mix.get("docs"), int):
            rng = np.random.default_rng([self.seed, _DOCS])
            self.docs = [rng.integers(0, self.vocab, int(mix["doc_tokens"]), dtype=np.int64)
                         for _ in range(int(mix["docs"]))]

    def _block(self, b: int) -> Dict:
        if b not in self._blocks:
            rng = np.random.default_rng([self.seed, b])
            n, mix = self.block, self.mix
            lo, hi = mix.get("question_tokens", mix.get("prompt_tokens"))
            blk = {"lengths": rng.permutation(_even(int(lo), int(hi), n)), "rng": rng}
            if self.docs:
                blk["doc"] = rng.permutation(np.arange(n) % len(self.docs))
            blk["tokens"] = [rng.integers(0, self.vocab, int(L), dtype=np.int64)
                             for L in blk["lengths"]]
            if self.mix.get("docs") == "fresh":
                frng = np.random.default_rng([self.seed, _FRESH, b])
                blk["fresh"] = [frng.integers(0, self.vocab, int(self.mix["doc_tokens"]),
                                              dtype=np.int64) for _ in range(n)]
            self._blocks = {b: blk}              # only the current block is kept
        return self._blocks[b]

    def request(self, i: int) -> Dict:
        """The i-th request: ``tokens`` (int64 prompt), ``doc`` (the pool
        index, -1 without one) and ``new_tokens``."""
        blk = self._block(i // self.block)
        k = i % self.block
        tail = blk["tokens"][k]
        doc = -1
        if self.docs:
            doc = int(blk["doc"][k])
            tokens = np.concatenate([self.docs[doc], tail])
        elif "fresh" in blk:
            tokens = np.concatenate([blk["fresh"][k], tail])
        else:
            tokens = tail
        return {"tokens": tokens, "doc": doc, "new_tokens": self.new_tokens}

    def longest_prompt(self) -> int:
        hi = self.mix.get("question_tokens", self.mix.get("prompt_tokens"))[1]
        return int(hi) + (int(self.mix["doc_tokens"]) if "doc_tokens" in self.mix else 0)

    def shortest_prompt(self) -> int:
        lo = self.mix.get("question_tokens", self.mix.get("prompt_tokens"))[0]
        return int(lo) + (int(self.mix["doc_tokens"]) if "doc_tokens" in self.mix else 0)
