"""Host-side page allocator: ctypes binding to the port's native pool,
``tpu_flash_torch/csrc/pagepool.cpp`` (a copy of the reference's
``csrc/pagepool.cpp``), with a pure-Python twin of every entry point.

The native pool owns admission control (all-or-nothing multi-page grants and
the decode reservation watermark), the page reference counts behind
prefix-cache sharing and checkpoint restore, and the prefix-cache index
itself (``pc_*``: content-addressed chains of full prompt pages, one lock
over them and the page references they hold). Python only mirrors the page
tables into device tensors.

The pool is host code: ``g++`` compiles it at first use into
``build/tpu_flash_torch/pagepool-<key>/`` at the repository root (the key
hashes the flags and the source); a failed build raises with the
compiler's output. ``force_python=True`` selects the twin, which gives the
same results on the same operation sequences; nothing falls back to it
silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from collections import OrderedDict
from typing import List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "pagepool.cpp")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "tpu_flash_torch")
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
_lib = None

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_p32, _p64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
# name: (restype, argtypes)
_SIGNATURES = {
    "pp_create": (_vp, [_i32] * 4),
    "pp_destroy": (None, [_vp]),
    "pp_num_free": (_i32, [_vp]),
    "pp_admit": (_i32, [_vp, _i32, _i32]),
    "pp_admit_shared": (_i32, [_vp, _i32, _p32, _i32, _i32]),
    "pp_retain": (_i32, [_vp, _i32]),
    "pp_release": (_i32, [_vp, _i32]),
    "pp_refcount": (_i32, [_vp, _i32]),
    "pp_extend": (_i32, [_vp, _i32]),
    "pp_free_seq": (None, [_vp, _i32]),
    "pp_restore": (_i32, [_vp, _i32, _p32, _i32]),
    "pp_pc_match": (_i32, [_vp, _p32, _i32, _i32, _i64, _p32, _i32]),
    "pp_pc_insert": (None, [_vp, _p32, _i32, _p32, _i32, _i32, _i32, _i64]),
    "pp_pc_evict": (_i32, [_vp, _i32]),
    "pp_pc_len": (_i32, [_vp]),
    "pp_pc_stats": (None, [_vp, _p64]),
    "pp_num_pages": (_i32, [_vp, _i32]),
    "pp_table": (_i32, [_vp, _i32, _p32, _i32]),
}


def library_path() -> str:
    """Where the pool's shared library lives: keyed by the flags and the
    source, so an edit of either builds afresh."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_ROOT, f"pagepool-{h.hexdigest()[:16]}",
                        "libpagepool.so")


def _load_native() -> ctypes.CDLL:
    """The native pool, compiled first if needed (into a temporary file
    renamed into place, so concurrent builds never load a partial
    library)."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(os.path.dirname(so), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
        os.close(fd)
        try:
            res = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC],
                                 capture_output=True, text=True, timeout=300)
            if res.returncode:
                raise RuntimeError(f"building the page pool failed:\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(so)
    for name, (res, args) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _lib = lib
    return lib


def _i32_array(values) -> ctypes.Array:
    values = [int(v) for v in values]
    return (ctypes.c_int32 * max(1, len(values)))(*(values or [0]))


class PageAllocator:
    """Allocator facade: the native pool, or its pure-Python twin
    (``force_python``)."""

    def __init__(
        self,
        total_pages: int,
        max_seqs: int,
        max_pages_per_seq: int,
        decode_reserve: int = 0,
        force_python: bool = False,
    ):
        self.total_pages = total_pages
        self.max_seqs = max_seqs
        self.max_pages_per_seq = max_pages_per_seq
        self.decode_reserve = decode_reserve
        self._lib = None if force_python else _load_native()
        if self._lib is not None:
            self._h = self._lib.pp_create(
                total_pages, max_seqs, max_pages_per_seq, decode_reserve
            )
            if not self._h:
                raise ValueError("pp_create failed")
        else:
            self._free = list(range(total_pages - 1, -1, -1))
            self._tables = [[] for _ in range(max_seqs)]
            self._active = [False] * max_seqs
            self._refs = [0] * total_pages
            # the prefix-cache index: (parent entry id, page tokens) →
            # (page, entry id), oldest first; entry ids never recycle
            self._pc: OrderedDict = OrderedDict()
            self._pc_next_id = 0
            self._pc_stats = dict(hits=0, misses=0, hit_tokens=0)

    @property
    def native(self) -> bool:
        return self._lib is not None

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.pp_destroy(self._h)
            self._h = None

    def _take_free(self) -> int:
        page = self._free.pop()
        self._refs[page] = 1
        return page

    def _drop_ref(self, page: int) -> None:
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)

    def _live(self, page: int) -> bool:
        return 0 <= page < self.total_pages and self._refs[page] > 0

    def num_free(self) -> int:
        if self._lib is not None:
            return self._lib.pp_num_free(self._h)
        return len(self._free)

    def admit(self, slot: int, npages: int) -> bool:
        """Grant ``npages`` fresh pages to an idle slot, all or nothing,
        keeping ``decode_reserve`` pages free."""
        if self._lib is not None:
            return self._lib.pp_admit(self._h, slot, npages) == 0
        if (
            slot < 0
            or slot >= self.max_seqs
            or self._active[slot]
            or npages < 0
            or npages > self.max_pages_per_seq
            or len(self._free) < npages + self.decode_reserve
        ):
            return False
        self._tables[slot] = [self._take_free() for _ in range(npages)]
        self._active[slot] = True
        return True

    def admit_shared(self, slot: int, shared, n_new: int) -> bool:
        """Admit with a table of existing ``shared`` pages (prefix-cache
        hits; each gains a reference) followed by ``n_new`` fresh pages.
        Only the fresh pages count against the free pool and the decode
        reserve. All or nothing."""
        shared = [int(p) for p in shared]
        if self._lib is not None:
            return self._lib.pp_admit_shared(
                self._h, slot, _i32_array(shared), len(shared), n_new) == 0
        if (
            slot < 0
            or slot >= self.max_seqs
            or self._active[slot]
            or n_new < 0
            or len(shared) + n_new > self.max_pages_per_seq
            or not all(self._live(p) for p in shared)
            or len(self._free) < n_new + self.decode_reserve
        ):
            return False
        for p in shared:
            self._refs[p] += 1
        self._tables[slot] = shared + [self._take_free() for _ in range(n_new)]
        self._active[slot] = True
        return True

    def retain(self, page: int) -> bool:
        """Add a reference to a live page (the prefix cache's hold)."""
        if self._lib is not None:
            return self._lib.pp_retain(self._h, page) > 0
        if not self._live(page):
            return False
        self._refs[page] += 1
        return True

    def release(self, page: int) -> bool:
        """Drop a reference; the page returns to the pool at zero."""
        if self._lib is not None:
            return self._lib.pp_release(self._h, page) >= 0
        if not self._live(page):
            return False
        self._drop_ref(page)
        return True

    def refcount(self, page: int) -> int:
        if self._lib is not None:
            return self._lib.pp_refcount(self._h, page)
        if not (0 <= page < self.total_pages):
            return -1
        return self._refs[page]

    def extend(self, slot: int) -> Optional[int]:
        """One more page for an active slot, or None (pool dry, or the slot
        at its cap)."""
        if self._lib is not None:
            page = self._lib.pp_extend(self._h, slot)
            return None if page < 0 else page
        if (
            slot < 0
            or slot >= self.max_seqs
            or not self._active[slot]
            or len(self._tables[slot]) >= self.max_pages_per_seq
            or not self._free
        ):
            return None
        page = self._take_free()
        self._tables[slot].append(page)
        return page

    def free_seq(self, slot: int) -> None:
        if self._lib is not None:
            self._lib.pp_free_seq(self._h, slot)
            return
        if 0 <= slot < self.max_seqs and self._active[slot]:
            for p in self._tables[slot]:
                self._drop_ref(p)
            self._tables[slot] = []
            self._active[slot] = False

    def num_pages(self, slot: int) -> int:
        if self._lib is not None:
            return self._lib.pp_num_pages(self._h, slot)
        if not (0 <= slot < self.max_seqs):
            return -1
        return len(self._tables[slot])

    def restore(self, slot: int, pages) -> bool:
        """Reinstate a slot's exact page table (checkpoint resume). Free
        pages are claimed; pages already live (restored into another slot
        first: prefix-shared tables) gain a reference. Duplicates are
        rejected; all or nothing; the decode reserve is bypassed (the pages
        were admitted before the snapshot)."""
        pages = [int(p) for p in pages]
        if self._lib is not None:
            return self._lib.pp_restore(
                self._h, slot, _i32_array(pages), len(pages)) == 0
        taken = set(pages)
        if (
            slot < 0
            or slot >= self.max_seqs
            or self._active[slot]
            or len(pages) > self.max_pages_per_seq
            or len(taken) != len(pages)
            or not all(0 <= p < self.total_pages for p in taken)
        ):
            return False
        self._free = [p for p in self._free if p not in taken]
        for p in pages:
            self._refs[p] += 1
        self._tables[slot] = pages
        self._active[slot] = True
        return True

    def table(self, slot: int) -> np.ndarray:
        """Slot's page ids padded with zeros to max_pages_per_seq."""
        out = np.zeros(self.max_pages_per_seq, np.int32)
        if self._lib is not None:
            buf = (ctypes.c_int32 * self.max_pages_per_seq)()
            n = self._lib.pp_table(self._h, slot, buf, self.max_pages_per_seq)
            out[:n] = np.frombuffer(buf, np.int32, n)
        else:
            t = self._tables[slot]
            out[: len(t)] = t
        return out

    # ---- the prefix-cache index (pp_pc_*) -------------------------------
    # Chains link by a monotonic entry id, never a recyclable page id: a key
    # is (parent entry id, page tokens), anchored at ``anchor`` (< 0, one
    # namespace each); each entry holds one page reference; LRU eviction.

    def pc_match(self, tokens, page_size: int, anchor: int = -1) -> List[int]:
        """Longest cached chain covering a page-aligned prefix of
        ``tokens``, leaving at least one token uncovered; page ids oldest
        first. Updates LRU order and the hit statistics."""
        tokens = [int(t) for t in tokens]
        n = len(tokens)
        if self._lib is not None:
            cap = max(1, (n - 1) // page_size) if n else 1
            out = (ctypes.c_int32 * cap)()
            got = self._lib.pp_pc_match(self._h, _i32_array(tokens), n,
                                        page_size, anchor, out, cap)
            return [int(out[i]) for i in range(max(0, got))]
        pages: List[int] = []
        parent = anchor
        if page_size > 0 and n > 0:
            for i in range((n - 1) // page_size):
                key = (parent, tuple(tokens[i * page_size:(i + 1) * page_size]))
                hit = self._pc.get(key)
                if hit is None:
                    break
                self._pc.move_to_end(key)
                page, parent = hit
                pages.append(page)
            if pages:
                self._pc_stats["hits"] += 1
                self._pc_stats["hit_tokens"] += len(pages) * page_size
            else:
                self._pc_stats["misses"] += 1
        return pages

    def pc_insert(self, tokens, table, page_size: int, max_entries: int,
                  anchor: int = -1) -> None:
        """Index the full pages of ``tokens`` backed by ``table`` (the
        slot's page ids in order). Existing entries dedupe and the chain
        continues through them; each newly indexed page gains a reference.
        LRU-evicts past ``max_entries``."""
        tokens = [int(t) for t in tokens]
        n = len(tokens)
        npages = min(n // page_size, len(table)) if page_size > 0 else 0
        if self._lib is not None:
            self._lib.pp_pc_insert(self._h, _i32_array(tokens), n,
                                   _i32_array(table[:npages]), npages,
                                   page_size, max_entries, anchor)
            return
        parent = anchor
        for i in range(npages):
            key = (parent, tuple(tokens[i * page_size:(i + 1) * page_size]))
            cur = self._pc.get(key)
            if cur is not None:
                self._pc.move_to_end(key)
                parent = cur[1]
                continue
            page = int(table[i])
            if not self.retain(page):
                break  # page not live: cannot index it
            self._pc_next_id += 1
            self._pc[key] = (page, self._pc_next_id)
            parent = self._pc_next_id
            while len(self._pc) > max_entries:
                self._pc_evict_one()

    def _pc_evict_one(self) -> int:
        _, (page, _) = self._pc.popitem(last=False)
        freed = int(self._refs[page] == 1)
        self._drop_ref(page)
        return freed

    def pc_evict(self, n: int) -> int:
        """Release the ``n`` least recently used entries; returns how many
        pages went back to the pool (a page still in a table frees
        nothing yet)."""
        if self._lib is not None:
            return self._lib.pp_pc_evict(self._h, n)
        freed = 0
        for _ in range(min(n, len(self._pc))):
            freed += self._pc_evict_one()
        return freed

    def pc_len(self) -> int:
        if self._lib is not None:
            return self._lib.pp_pc_len(self._h)
        return len(self._pc)

    def pc_stats(self) -> dict:
        if self._lib is not None:
            out = (ctypes.c_int64 * 4)()
            self._lib.pp_pc_stats(self._h, out)
            return dict(hits=int(out[0]), misses=int(out[1]),
                        hit_tokens=int(out[2]), entries=int(out[3]))
        return dict(self._pc_stats, entries=len(self._pc))
