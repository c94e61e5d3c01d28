"""Prefix caching: copy-on-write sharing of prompt KV pages; port of
``tpu_flash/serving/prefix_cache.py``.

Attention is causal, so a full page of K/V depends only on the tokens at
and before it: a full page computed for one sequence is the page any other
sequence with the same token prefix needs. The index maps full prompt
pages by content and lets the engine skip both the prefill compute and the
page memory of every cached prefix page.

* **Full pages only.** A sequence's trailing partial page is private
  (decode appends land there); only pages wholly covered by the prompt are
  immutable and shareable, so no kernel ever writes a shared page.
* **Content addressing by chain key** ``(parent entry id, page tokens)``,
  anchored at ``-2 - adapter_id`` (the base model at -1): a key pins the
  whole token prefix, exactly (the tokens are the key). Chains link by a
  monotonic entry id, never a recyclable page id.
* **Refcounts live in the page pool** (``cache/allocator.py``): a table
  entry holds one reference, the index one per retained page; sharing is
  ``admit_shared`` and eviction ``release``, so the engine's free and
  preempt paths need no special case.
* **LRU eviction**, by entry count and on demand when the pool runs dry:
  the engine evicts before it preempts a live sequence.

The index itself lives in the allocator (``pc_*``: the native pool's, or
its Python twin's), next to the references it takes.
"""

from __future__ import annotations

from typing import List, Sequence


class PrefixCache:
    """Content-addressed index of immutable full prompt pages.

    ``alloc`` is the engine's PageAllocator; page ids are allocator ids
    (the engine shifts them by one for the device tables). ``max_entries``
    bounds the index."""

    def __init__(self, alloc, max_entries: int = 4096):
        self._alloc = alloc
        self._max = max_entries

    def __len__(self) -> int:
        return self._alloc.pc_len()

    def match(self, prompt: Sequence[int], page_size: int,
              anchor: int = -1) -> List[int]:
        """Longest cached page chain covering a page-aligned prefix of
        ``prompt``, leaving at least one prompt token uncovered (the tail
        prefill must still produce next-token logits). Allocator page ids,
        oldest first; updates LRU order and the statistics."""
        return self._alloc.pc_match(prompt, page_size, anchor)

    def insert(self, prompt: Sequence[int], table, page_size: int,
               anchor: int = -1) -> None:
        """Register a prefilled slot's full prompt pages; ``table`` is the
        slot's allocator page ids in order (it may begin with shared pages,
        which dedupe onto their entries). Each newly indexed page gains a
        reference, so it outlives its sequence."""
        self._alloc.pc_insert(prompt, table, page_size, self._max, anchor)

    def evict(self, n: int = 1) -> int:
        """Release the ``n`` least recently used entries; returns how many
        pages went back to the pool."""
        return self._alloc.pc_evict(n)

    def clear(self) -> None:
        self.evict(len(self))

    def stats(self) -> dict:
        """``hits``, ``misses``, ``hit_tokens`` and ``entries``."""
        return self._alloc.pc_stats()
