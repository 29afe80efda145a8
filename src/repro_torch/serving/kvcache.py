"""Paged KV-cache manager for the multi-tenant serving engine.

Pages are fixed-size blocks of KV slots (default 128 tokens).  The page table
is host-side (numpy) — allocation/free is control-plane work; the device-side
cache is the dense per-layer tensor managed by ``repro_torch.models`` with slot
indices assigned here.  The LAGS admission scheduler charges each tenant for
resident pages; evicting a tenant releases its pages (this is the engine's
"context switch" cost accounted in ``engine.py``).

Copy of ``repro.serving.kvcache``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class PagedAllocator:
    n_pages: int
    page_tokens: int = 128

    def __post_init__(self):
        self.free_list: List[int] = list(range(self.n_pages))
        self.owner: Dict[int, list] = {}  # seq_id -> pages

    @property
    def free_pages(self) -> int:
        return len(self.free_list)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_tokens)

    def can_allocate(self, n_tokens: int) -> bool:
        return self.pages_for(n_tokens) <= self.free_pages

    def allocate(self, seq_id: int, n_tokens: int) -> Optional[np.ndarray]:
        need = self.pages_for(n_tokens)
        if need > self.free_pages:
            return None
        pages = [self.free_list.pop() for _ in range(need)]
        self.owner.setdefault(seq_id, []).extend(pages)
        return np.asarray(pages, np.int32)

    def extend(self, seq_id: int, cur_tokens: int, new_tokens: int):
        """Grow a sequence; returns newly allocated pages (may be empty)."""
        have = len(self.owner.get(seq_id, [])) * self.page_tokens
        need = self.pages_for(cur_tokens + new_tokens) - len(
            self.owner.get(seq_id, [])
        )
        if need <= 0:
            return np.empty(0, np.int32)
        if need > self.free_pages:
            return None
        pages = [self.free_list.pop() for _ in range(need)]
        self.owner[seq_id].extend(pages)
        del have
        return np.asarray(pages, np.int32)

    def free(self, seq_id: int) -> int:
        pages = self.owner.pop(seq_id, [])
        self.free_list.extend(pages)
        return len(pages)

    def utilization(self) -> float:
        return 1.0 - self.free_pages / self.n_pages
