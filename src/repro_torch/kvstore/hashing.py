"""Incremental per-page content addressing for token prefixes.

The flat ``PrefixCache`` keyed entries by ``sha1(tokens[:n])`` and probed
every page boundary — O(L) hash work per boundary, O(L^2) per lookup on
long prompts. Here a prefix is addressed by a *chain* of per-page digests:

    key_0 = H(page_0)
    key_i = H(key_{i-1} || page_i)

so ``key_i`` commits to the entire prefix up to page ``i`` (same collision
semantics as hashing the whole prefix) but computing *all* boundary keys of
an L-token prompt is a single O(L) pass. ``chain_keys`` is the only hash
the radix store ever takes of a token stream.

Legacy-shim (one release): entries written by the old whole-prefix SHA-1
scheme stay readable — ``legacy_prefix_key`` reproduces the old key, and
``HostKVPool`` aliases both keys to one entry (see
``serving.kv_cache.PrefixCache.store``).

Invariants (property-tested in ``tests/test_kvstore.py``):

  * **prefix commitment** — ``chain_keys(t, p)[i]`` equals
    ``chain_keys(t', p)[i]`` iff the first ``(i+1)*p`` tokens agree
    (modulo hash collisions): equal prefixes share keys across tenants
    and engines, which is what makes a ``KVHandle`` (a bare chain key)
    a sufficient cross-process exchange token.
  * **alignment** — keys exist only at page boundaries; a sub-page tail
    never gets a key and is never stored.
"""
from __future__ import annotations

import hashlib
from typing import List

import numpy as np

_DIGEST_SIZE = 16


def page_bytes_of(tokens: np.ndarray, page_size: int, i: int) -> bytes:
    """Raw bytes of page ``i`` (used as exact radix edge labels)."""
    page = tokens[i * page_size:(i + 1) * page_size]
    return np.ascontiguousarray(page).tobytes()


def chain_keys(tokens: np.ndarray, page_size: int) -> List[str]:
    """Chained per-page prefix keys for every complete page, in one O(L)
    pass. ``chain_keys(t, p)[i]`` addresses the page-aligned prefix
    ``t[:(i + 1) * p]``."""
    n_pages = len(tokens) // page_size
    keys: List[str] = []
    prev = b""
    for i in range(n_pages):
        d = hashlib.blake2b(prev, digest_size=_DIGEST_SIZE)
        d.update(page_bytes_of(tokens, page_size, i))
        raw = d.digest()
        keys.append(raw.hex())
        prev = raw
    return keys


def legacy_prefix_key(tokens: np.ndarray) -> str:
    """The pre-radix whole-prefix SHA-1 key (deprecated; kept one release
    so entries and external key references written under the old scheme
    remain resolvable)."""
    return hashlib.sha1(np.ascontiguousarray(tokens).tobytes()).hexdigest()
