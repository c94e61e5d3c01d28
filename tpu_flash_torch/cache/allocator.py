"""Host-side page allocator: ctypes binding to the native pool in
``csrc/pagepool.cpp`` (shared with the reference package), with the same
pure-Python fallback when no compiler exists.

The native pool owns admission control (all-or-nothing multi-page grants and
the decode reservation watermark), so the engine can neither leak nor
deadlock pages; Python only mirrors the page tables into device tensors.
Only the calls the serving slice uses are bound; prefix-cache sharing and
checkpoint restore come with ROADMAP A7.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "csrc")
_SO = os.path.join(_CSRC, "libpagepool.so")
_lib = None
_lib_tried = False


def _load_native():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(
            os.path.join(_CSRC, "pagepool.cpp")
        ):
            subprocess.run(
                ["make", "-C", _CSRC], check=True, capture_output=True, timeout=120
            )
        lib = ctypes.CDLL(_SO)
    except (OSError, subprocess.SubprocessError):
        return None
    i32, vp = ctypes.c_int32, ctypes.c_void_p
    lib.pp_create.restype = vp
    lib.pp_create.argtypes = [i32] * 4
    lib.pp_destroy.restype = None
    lib.pp_destroy.argtypes = [vp]
    lib.pp_num_free.restype = i32
    lib.pp_num_free.argtypes = [vp]
    lib.pp_admit.restype = i32
    lib.pp_admit.argtypes = [vp, i32, i32]
    lib.pp_extend.restype = i32
    lib.pp_extend.argtypes = [vp, i32]
    lib.pp_free_seq.restype = None
    lib.pp_free_seq.argtypes = [vp, i32]
    lib.pp_num_pages.restype = i32
    lib.pp_num_pages.argtypes = [vp, i32]
    lib.pp_table.restype = i32
    lib.pp_table.argtypes = [vp, i32, ctypes.POINTER(i32), i32]
    _lib = lib
    return _lib


class PageAllocator:
    """Allocator facade: native pool when available, Python otherwise."""

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

    @property
    def native(self) -> bool:
        return self._lib is not None

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.pp_destroy(self._h)
            self._h = None

    def num_free(self) -> int:
        if self._lib is not None:
            return self._lib.pp_num_free(self._h)
        return len(self._free)

    def admit(self, slot: int, npages: int) -> bool:
        if self._lib is not None:
            return self._lib.pp_admit(self._h, slot, npages) == 0
        if (
            slot < 0
            or slot >= self.max_seqs
            or self._active[slot]
            or npages > self.max_pages_per_seq
            or len(self._free) < npages + self.decode_reserve
        ):
            return False
        self._tables[slot] = [self._free.pop() for _ in range(npages)]
        self._active[slot] = True
        return True

    def extend(self, slot: int) -> Optional[int]:
        if self._lib is not None:
            page = self._lib.pp_extend(self._h, slot)
            return None if page < 0 else page
        if (
            not self._active[slot]
            or len(self._tables[slot]) >= self.max_pages_per_seq
            or not self._free
        ):
            return None
        page = self._free.pop()
        self._tables[slot].append(page)
        return page

    def free_seq(self, slot: int) -> None:
        if self._lib is not None:
            self._lib.pp_free_seq(self._h, slot)
            return
        if self._active[slot]:
            self._free.extend(self._tables[slot])
            self._tables[slot] = []
            self._active[slot] = False

    def num_pages(self, slot: int) -> int:
        if self._lib is not None:
            return self._lib.pp_num_pages(self._h, slot)
        return len(self._tables[slot])

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
