"""Radix index over token prefixes -> resident KV pool blocks (a copy of
``repro/serve/prefix.py``; the port keeps its own so it never imports the
JAX package).

Copy-on-write prefix sharing (docs/ARCHITECTURE.md §"Prefix sharing"):
production traffic is many users hitting a handful of shared system
prompts, so the scheduler keeps a trie whose edges are *block-sized token
runs* and whose nodes name the pool block holding that run's KV.  A new
request walks the trie with its prompt and leaves with the longest
resident prefix:

* **full blocks** — every ``block_size``-token edge that matches exactly is
  shared by reference: the scheduler bumps the block's refcount in
  :class:`~repro_torch.serve.scheduler.BlockAllocator` and points the new
  request's block-table row at the same physical pages.  N users on one
  system prompt cost one set of pages and one prefill.
* **partial block** — when the prompt diverges *inside* a resident block
  (a non-block-aligned divergence point), the matched head of that block
  is still reusable KV; the scheduler forks it — copies the pages to a
  fresh block and prefills only the divergent tail.  This is the
  copy-on-write event: the resident block is never written by a sharer.

Matching is capped at ``len(prompt) - 1`` tokens: the unified step samples
a request's first output token from the logits of its final prompt row, so
even a fully-resident prompt must leave one row to prefill (vLLM's prefix
cache makes the same cut).

The index holds **no references of its own**: a node is valid exactly while
some live request holds its block (refcount > 0).  The scheduler calls
:meth:`forget` for every block the allocator actually releases, which drops
the node *and its subtree* — children encode longer prefixes that are
unreachable without the parent, so keeping them could at worst hide
shareable blocks, never corrupt a match.

KV pages are a pure function of the token prefix (causal attention,
deterministic forward), so token-content matching is exact: a block may
hold prompt tokens, generated tokens, or a mix — once full it never changes
(per-slot lengths are monotone; rejected speculative rows are rolled back
before registration) and any request whose prompt matches its content would
have written byte-identical pages, including the int8 quantization grid.
"""

from __future__ import annotations

from typing import Optional


class _Node:
    __slots__ = ("key", "block", "parent", "children")

    def __init__(self, key, block: int, parent: Optional["_Node"]):
        self.key = key  # tuple of block_size tokens (None at the root)
        self.block = block  # pool block id holding this run's KV
        self.parent = parent
        self.children: dict[tuple, _Node] = {}


class PrefixIndex:
    """Trie of block-sized token runs -> resident pool block ids."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._root = _Node(None, -1, None)
        self._by_block: dict[int, _Node] = {}

    def __len__(self) -> int:
        return len(self._by_block)

    # ------------------------------------------------------------- matching
    def match(self, tokens) -> tuple[list[int], Optional[tuple[int, int]], int]:
        """Longest resident prefix of ``tokens``.

        Returns ``(full, partial, n)``: ``full`` is the list of pool blocks
        whose entire ``block_size``-token run matches (share by refcount),
        ``partial`` is ``(block, k)`` when the next resident block matches
        only its first ``k < block_size`` tokens (fork-on-write candidate),
        and ``n = len(full) * block_size + k`` is the total matched token
        count, capped at ``len(tokens) - 1``.
        """
        bs = self.block_size
        toks = [int(t) for t in tokens]
        cap = len(toks) - 1
        if cap <= 0 or not self._root.children:
            return [], None, 0
        node, full = self._root, []
        p = 0
        while p + bs <= len(toks):
            child = node.children.get(tuple(toks[p : p + bs]))
            if child is None:
                break
            full.append(child.block)
            node, p = child, p + bs
        # best partial continuation among the children (divergence mid-block)
        best_block, best_k = -1, 0
        want = toks[p : p + bs]
        if want:
            for key, child in node.children.items():
                k = 0
                while k < len(want) and key[k] == want[k]:
                    k += 1
                if k > best_k:
                    best_block, best_k = child.block, k
        matched = min(p + best_k, cap)
        n_full, k = matched // bs, matched % bs
        if k == 0:
            return full[:n_full], None, matched
        # the partial block is either a trimmed full match or the best child
        blk = full[n_full] if n_full < len(full) else best_block
        return full[:n_full], (blk, k), matched

    # --------------------------------------------------------- registration
    def register(self, tokens, blocks: list[int]) -> int:
        """Walk/extend the path for ``tokens``, mapping the i-th full
        ``block_size``-token run to ``blocks[i]``.

        An existing node keeps its block (the first resident copy wins —
        identical content in two physical blocks is indexed once); the
        duplicate simply stays private to its owner.  Returns the number of
        newly indexed blocks."""
        bs = self.block_size
        toks = [int(t) for t in tokens]
        node, new = self._root, 0
        for i, b in enumerate(blocks):
            key = tuple(toks[i * bs : (i + 1) * bs])
            if len(key) < bs:
                break
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(b), node)
                node.children[key] = child
                self._by_block[int(b)] = child
                new += 1
            node = child
        return new

    # --------------------------------------------------------- invalidation
    def forget(self, block: int) -> None:
        """Drop the node for a released block (and its now-unreachable
        subtree).  Tolerates blocks that were never indexed or whose node
        was already dropped with an ancestor — the allocator frees in
        arbitrary order within one release."""
        node = self._by_block.pop(int(block), None)
        if node is None:
            return
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        stack = list(node.children.values())
        while stack:
            n = stack.pop()
            if self._by_block.get(n.block) is n:
                del self._by_block[n.block]
            stack.extend(n.children.values())
