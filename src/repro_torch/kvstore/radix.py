"""Page-granular radix prefix index (SGLang/vLLM-style).

Each node owns one KV *page* (``page_size`` tokens); the path from the
root to a node spells a page-aligned token prefix. Two requests sharing a
system prompt therefore share the same nodes — unlike whole-prefix
hashing, where each stored conversation duplicates every shared byte under
a different key.

``match`` walks the tree page by page (children are keyed by the exact
raw bytes of the next page, so a lookup is O(pages) dict probes with no
collision risk) and returns the longest stored page-aligned prefix.

Invariants (asserted in ``remove`` and exercised by
``tests/test_kvstore.py`` / ``tests/test_disagg.py``):

  * **ref-count safety** — a page with ``refs > 0`` (pinned by an
    in-flight transfer, or held by a cross-engine ``PageLease``) can
    never be evicted; ``pin``/``unpin`` must balance exactly (asserted).
  * **leaf-only removal** — only childless pages may be removed: an
    interior page backs every stored sequence that runs through it, so
    evicting it would orphan longer prefixes.
  * **path consistency** — ``path_to(key)`` returns the same pages, in
    the same order, as re-matching the tokens that produced ``key``:
    a published handle is exchangeable across engines without re-hashing
    the token stream.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from .hashing import chain_keys, page_bytes_of
from .tiers import Tier


@dataclasses.dataclass(eq=False)
class Page:
    """One page of cached KV: content-addressed, tiered, ref-counted."""

    key: str                      # chain key (commits to the whole prefix)
    depth: int                    # 1-based page number along its path
    n_tokens: int
    nbytes: int
    tier: Tier = Tier.GPU
    refs: int = 0
    last_used: int = 0            # logical tick (deterministic LRU)
    hits: int = 0
    tenants: Set[str] = dataclasses.field(default_factory=set)
    terminal: bool = False        # a stored sequence ends at this page
    exact_only: bool = False      # SSM snapshot: only exact-prefix reuse
    payload: Any = None           # terminal payload (full-hit round trips)
    spec: bool = False            # staged by predictive promotion, unhit yet


class _Node:
    __slots__ = ("page", "children", "parent", "edge")

    def __init__(
        self,
        page: Optional[Page],
        parent: Optional["_Node"],
        edge: Optional[bytes],
    ) -> None:
        self.page = page
        self.parent = parent
        self.edge = edge                       # raw bytes of this page
        self.children: Dict[bytes, _Node] = {}


class RadixPrefixIndex:
    """Longest-page-aligned-prefix index over ref-counted pages."""

    def __init__(self, page_size: int) -> None:
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.page_size = page_size
        self._root = _Node(None, None, None)
        self._nodes: Dict[str, _Node] = {}     # chain key -> node
        self._tick = itertools.count(1)
        self.total_bytes = 0
        self.n_pages = 0

    # -- queries --------------------------------------------------------
    def touch(self, pages: List[Page]) -> None:
        t = next(self._tick)
        for p in pages:
            p.last_used = t

    def match(self, tokens: np.ndarray) -> List[Page]:
        """Pages of the longest stored page-aligned prefix of ``tokens``
        (empty list = miss). O(pages) dict probes."""
        node = self._root
        out: List[Page] = []
        n_pages = len(tokens) // self.page_size
        for i in range(n_pages):
            child = node.children.get(
                page_bytes_of(tokens, self.page_size, i)
            )
            if child is None:
                break
            out.append(child.page)
            node = child
        return out

    def get(self, key: str) -> Optional[Page]:
        node = self._nodes.get(key)
        return node.page if node is not None else None

    def path_to(self, key: str) -> List[Page]:
        """Root-to-``key`` page path (empty list if the key is unknown) —
        the handle-exchange lookup: a chain key commits to its whole
        prefix, so the path is exactly the pages a fetch of that prefix
        needs, without re-hashing the token stream."""
        node = self._nodes.get(key)
        if node is None:
            return []
        out: List[Page] = []
        while node is not None and node.page is not None:
            out.append(node.page)
            node = node.parent
        out.reverse()
        return out

    def subtree(self, page: Page, budget: int) -> List[Page]:
        """Pages strictly below ``page``, BFS order (shallow first),
        visiting at most ``budget`` nodes — the predictive-promotion
        candidate walk: the descendants of a touched prefix are the
        continuations (this session's own deeper turns, sibling sessions
        forked off the same shared prefix) most likely to be fetched
        next. Deterministic: children iterate in insertion order."""
        node = self._nodes.get(page.key)
        out: List[Page] = []
        if node is None or budget <= 0:
            return out
        queue = deque(node.children.values())
        while queue and len(out) < budget:
            n = queue.popleft()
            out.append(n.page)
            queue.extend(n.children.values())
        return out

    # -- mutation -------------------------------------------------------
    def insert(
        self,
        tokens: np.ndarray,
        nbytes_per_page: int,
        tenant: str = "default",
    ) -> Tuple[List[Page], List[Page]]:
        """Walk/extend the tree with every complete page of ``tokens``.
        Returns ``(path_pages, new_pages)`` — new pages start in the GPU
        tier (just produced on device, not yet written back)."""
        keys = chain_keys(tokens, self.page_size)
        node = self._root
        path: List[Page] = []
        fresh: List[Page] = []
        for i, key in enumerate(keys):
            edge = page_bytes_of(tokens, self.page_size, i)
            child = node.children.get(edge)
            if child is None:
                page = Page(
                    key=key,
                    depth=i + 1,
                    n_tokens=self.page_size,
                    nbytes=nbytes_per_page,
                )
                child = _Node(page, node, edge)
                node.children[edge] = child
                self._nodes[key] = child
                self.total_bytes += nbytes_per_page
                self.n_pages += 1
                fresh.append(page)
            child.page.tenants.add(tenant)
            path.append(child.page)
            node = child
        self.touch(path)
        return path, fresh

    def pin(self, pages: List[Page]) -> None:
        for p in pages:
            p.refs += 1

    def unpin(self, pages: List[Page]) -> None:
        for p in pages:
            p.refs -= 1
            assert p.refs >= 0, f"unbalanced unpin on page {p.key}"

    # -- eviction -------------------------------------------------------
    def evictable(self) -> List[Page]:
        """Pages that may be removed right now: unreferenced leaves.
        Interior pages back longer stored prefixes and become leaves only
        once their subtree is gone."""
        out = []
        for node in self._nodes.values():
            if not node.children and node.page.refs == 0:
                out.append(node.page)
        return out

    def remove(self, page: Page) -> None:
        """Detach an unreferenced leaf page. Asserts both safety
        invariants — eviction can never free a pinned or interior page."""
        node = self._nodes.get(page.key)
        assert node is not None and node.page is page, "unknown page"
        assert page.refs == 0, "evicting a ref-counted page"
        assert not node.children, "evicting an interior page"
        del node.parent.children[node.edge]
        del self._nodes[page.key]
        self.total_bytes -= page.nbytes
        self.n_pages -= 1

    # -- introspection --------------------------------------------------
    def pages(self) -> List[Page]:
        return [n.page for n in self._nodes.values()]

    def __len__(self) -> int:
        return self.n_pages
