"""Paged device bank for ragged in-flight encoder outputs.

Encoder outputs live in fixed-size pages, so a 1-frame clip holds fewer
pages than a max-frame one for its whole time in flight:

- three device pools, ``mem [N+1, P, E]``, ``proj [N+1, P, A]`` and
  ``mask [N+1, P]``, hold N pages of P memory slots each;
- a host free list hands pages out at admission and takes them back at
  completion (pure Python, no device traffic);
- a device page table (int32 ``[rows, pages_per_row]``) plus per-row
  lengths maps each decode lane to its pages; the paged stride kernel reads
  pages through it, and :func:`gather_bank` builds the dense bank from it;
- page 0 is the shared zero page: mask 0 everywhere, so table padding
  reads slots the attention softmax excludes.

The pool and the table grow in place (:meth:`PageBank.grow`,
:meth:`PageBank.grow_rows`, for ``CaptionService.grow_capacity``); they
never shrink.
"""

from __future__ import annotations

from collections import deque
from typing import Hashable

import numpy as np
import torch

from cst_captioning_tpu_torch.ops.decode_stride import gather_pages


class OutOfPages(RuntimeError):
    """The pool cannot hold another request's pages right now
    (backpressure: the request stays queued until completions free pages)."""


def gather_bank(pools, table):
    """Dense ``[B, W, *]`` bank from ``(mem, proj, mask)`` pools and a
    ``[B, width]`` page table."""
    return gather_pages(*pools, table)


class PageBank:
    """Fixed-size page pool with a host free list and a device page table.

    ``num_pages`` counts usable pages, excluding the zero page (id 0);
    ``page_size`` is P. The pools are allocated on ``device`` at the first
    :meth:`store`, with the dims and dtypes of that encoder output.
    """

    def __init__(self, num_pages: int, page_size: int,
                 device: torch.device | str = "cpu"):
        if num_pages < 1 or page_size < 1:
            raise ValueError(
                f"need num_pages >= 1 and page_size >= 1, got "
                f"{num_pages}, {page_size}"
            )
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.device = torch.device(device)
        self._free: deque[int] = deque(range(1, self.num_pages + 1))
        self._owned: dict[Hashable, list[int]] = {}
        self._lens: dict[Hashable, int] = {}
        self.mem = None    # [N+1, P, E]
        self.proj = None   # [N+1, P, A]
        self.mask = None   # [N+1, P] float32
        self.row_table = None   # device [rows, width] int32 (init_rows)
        self.row_lens = None    # device [rows] int32 memory lengths
        self.pages_hwm = 0

    # ---- host-side accounting ----------------------------------------------

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, m_len: int) -> int:
        return -(-int(m_len) // self.page_size)

    def can_fit(self, m_len: int) -> bool:
        return self.pages_for(m_len) <= len(self._free)

    def alloc(self, owner: Hashable, m_len: int) -> list[int]:
        """Reserve pages for ``m_len`` memory slots; raises OutOfPages."""
        if owner in self._owned:
            raise ValueError(f"owner {owner!r} already holds pages")
        n = self.pages_for(m_len)
        if n > len(self._free):
            raise OutOfPages(
                f"{n} page(s) requested, {len(self._free)} free "
                f"(pool {self.num_pages} x {self.page_size} slots)"
            )
        pages = [self._free.popleft() for _ in range(n)]
        self._owned[owner] = pages
        self._lens[owner] = int(m_len)
        self.pages_hwm = max(self.pages_hwm, self.pages_in_use)
        return pages

    def free(self, owner: Hashable) -> None:
        """Return an owner's pages (no device writes: a freed page is
        unreachable until re-allocation overwrites it)."""
        for p in self._owned.pop(owner, ()):
            self._free.append(p)
        self._lens.pop(owner, None)

    def owned(self, owner: Hashable) -> list[int]:
        return list(self._owned.get(owner, ()))

    def length(self, owner: Hashable) -> int:
        return self._lens.get(owner, 0)

    def table(self, owners: list[Hashable | None], width: int) -> np.ndarray:
        """Host page-table rows for ``owners`` (None/unknown -> zero pages),
        padded to ``width`` pages with the zero page."""
        out = np.zeros((len(owners), width), np.int32)
        for i, owner in enumerate(owners):
            pages = self._owned.get(owner, ()) if owner is not None else ()
            if len(pages) > width:
                raise ValueError(
                    f"owner {owner!r} holds {len(pages)} pages > table "
                    f"width {width}"
                )
            out[i, : len(pages)] = pages
        return out

    def snapshot(self) -> dict:
        """JSON-ready accounting snapshot."""
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "free": list(self._free),
            "owned": {str(k): list(v) for k, v in self._owned.items()},
            "lengths": {str(k): v for k, v in self._lens.items()},
            "pages_hwm": self.pages_hwm,
        }

    # ---- device page table -------------------------------------------------

    def init_rows(self, rows: int, width: int) -> None:
        """Allocate the device page table ``row_table [rows, width]`` and the
        per-row lengths ``row_lens [rows]``, all pointing at the zero page."""
        self.row_table = torch.zeros((int(rows), int(width)),
                                     dtype=torch.int32, device=self.device)
        self.row_lens = torch.zeros((int(rows),), dtype=torch.int32,
                                    device=self.device)

    def bind_row(self, row: int, owner: Hashable) -> None:
        """Point table row ``row`` at ``owner``'s pages."""
        width = self.row_table.shape[1]
        self.row_table[row] = torch.from_numpy(self.table([owner], width)[0])
        self.row_lens[row] = self._lens.get(owner, 0)

    def clear_row(self, row: int) -> None:
        """Reset table row ``row`` to the zero page (lane freed)."""
        self.row_table[row] = 0
        self.row_lens[row] = 0

    def grow_rows(self, rows: int) -> None:
        """Grow the device table to ``rows`` rows; new rows point at the
        zero page. Rows only grow."""
        cur = self.row_table.shape[0]
        new_r = int(rows)
        if new_r < cur:
            raise ValueError(
                f"grow_rows({rows}) below current row count {cur} — rows "
                "only grow (shrink = drain and rebuild)"
            )
        extra = new_r - cur
        self.row_table = torch.nn.functional.pad(self.row_table,
                                                 (0, 0, 0, extra))
        self.row_lens = torch.nn.functional.pad(self.row_lens, (0, extra))

    def grow(self, num_pages: int) -> None:
        """Grow the pool to ``num_pages`` usable pages: the free list gains
        the new ids and the device pools, once allocated, zero-pad along
        the page axis, so stored pages, the table and the zero page stay
        as they are. The pool only grows."""
        new_n = int(num_pages)
        if new_n < self.num_pages:
            raise ValueError(
                f"PageBank.grow({num_pages}) below current pool size "
                f"{self.num_pages} — the pool only grows (shrink = drain "
                "and rebuild)"
            )
        extra = new_n - self.num_pages
        self._free.extend(range(self.num_pages + 1, new_n + 1))
        self.num_pages = new_n
        if self.mem is not None and extra:
            grow = lambda x: torch.cat(  # noqa: E731
                [x, x.new_zeros((extra,) + tuple(x.shape[1:]))])
            self.mem = grow(self.mem)
            self.proj = grow(self.proj)
            self.mask = grow(self.mask)

    # ---- device pools ------------------------------------------------------

    def store(self, pages: list[int], memory: torch.Tensor,
              proj: torch.Tensor, mask: torch.Tensor) -> None:
        """Scatter one encoder output (``[1, M, *]`` leaves) into ``pages``;
        the tail past M pads with mask 0."""
        n = len(pages)
        M = int(memory.shape[1])
        if n != self.pages_for(M):
            raise ValueError(
                f"{n} page(s) passed for M={M} (need {self.pages_for(M)})"
            )
        P = self.page_size
        if self.mem is None:
            rows = self.num_pages + 1
            self.mem = torch.zeros((rows, P, memory.shape[-1]),
                                   dtype=memory.dtype, device=self.device)
            self.proj = torch.zeros((rows, P, proj.shape[-1]),
                                    dtype=proj.dtype, device=self.device)
            self.mask = torch.zeros((rows, P), dtype=torch.float32,
                                    device=self.device)
        pad = n * P - M
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        pad_rows = lambda x: torch.nn.functional.pad(  # noqa: E731
            x[0], (0, 0, 0, pad))
        self.mem[idx] = pad_rows(memory).reshape(n, P, -1)
        self.proj[idx] = pad_rows(proj).reshape(n, P, -1)
        self.mask[idx] = torch.nn.functional.pad(
            mask[0].float(), (0, pad)).reshape(n, P)
