"""Host-side page accounting for the paged KV layout — the port's own
copy of dlrover_tpu/serving/paged_kv.py (pure Python, no device
traffic; the port imports nothing from the JAX package).

The device side is a global page pool `[L, n_pages, page_size, KV, hd]`
plus per-slot page tables (models/decode.py paged primitives). Which
physical pages a request owns, and how many runs share each page,
lives here: the allocator hands out integers; the engine turns them
into table writes.

Page 0 is the TRASH page: permanently allocated, never handed out,
never freed. Done/retired slots' table rows park on it so frozen
rewrites land where no live table reads.
"""

from typing import Dict, List, Tuple

TRASH_PAGE = 0


class OutOfPages(RuntimeError):
    """The pool cannot satisfy an allocation."""


class PageAllocator:
    """Ref-counted free-list allocator over `n_pages` physical pages
    of `page_size` cells. Deterministic: fresh pages come out in
    ascending id order, freed pages are reused LIFO — same inputs,
    same page ids."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page 0 is the trash page), "
                f"got {n_pages}"
            )
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        # ascending pop() order: the list is stored reversed
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self.pages_allocated = 0
        self.pages_freed = 0
        self.pages_shared = 0
        self.cow_copies = 0

    @property
    def capacity(self) -> int:
        """Allocatable pages (trash excluded)."""
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.capacity - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages with more than one referencing run."""
        return sum(1 for r in self._refs.values() if r > 1)

    def pages_for(self, cells: int) -> int:
        """Pages covering `cells` logical cells."""
        return max(1, -(-cells // self.page_size))

    def alloc(self, n: int) -> List[int]:
        """Hand out `n` fresh pages, each at refcount 1."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise OutOfPages(
                f"need {n} pages, {len(self._free)} free "
                f"of {self.capacity}"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.pages_allocated += n
        return pages

    def share(self, pages: List[int]) -> None:
        """Add one referencing run to each page."""
        for p in pages:
            if p == TRASH_PAGE:
                continue
            if p not in self._refs:
                raise ValueError(f"share of unallocated page {p}")
            self._refs[p] += 1
        self.pages_shared += len(pages)

    def free(self, pages: List[int]) -> None:
        """Drop one referencing run from each page; pages reaching
        refcount 0 return to the free list. Trash ids pass through."""
        for p in pages:
            if p == TRASH_PAGE:
                continue
            r = self._refs.get(p)
            if r is None:
                raise ValueError(f"double free of page {p}")
            if r == 1:
                del self._refs[p]
                self._free.append(p)
                self.pages_freed += 1
            else:
                self._refs[p] = r - 1

    def cow(self, page: int) -> Tuple[int, bool]:
        """Make `page` writable for ONE of its referencing runs:
        exclusive -> same page, no copy; shared -> a fresh page at
        refcount 1 and True (a device copy is required). Raises
        OutOfPages with the refcount untouched when the pool is dry."""
        r = self._refs.get(page)
        if r is None:
            raise ValueError(f"cow of unallocated page {page}")
        if r == 1:
            return page, False
        if not self._free:
            raise OutOfPages(
                f"cow of shared page {page}: pool dry "
                f"({self.capacity} pages)"
            )
        [fresh] = self.alloc(1)
        self._refs[page] = r - 1
        self.cow_copies += 1
        return fresh, True

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def check(self) -> None:
        """Assert the accounting invariants: free and allocated
        partition the capacity, every refcount is positive, no id
        appears twice, trash is never tracked."""
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise AssertionError("duplicate page in free list")
        if TRASH_PAGE in free_set or TRASH_PAGE in self._refs:
            raise AssertionError("trash page entered circulation")
        alloc_set = set(self._refs)
        if free_set & alloc_set:
            raise AssertionError(
                f"pages both free and allocated: {free_set & alloc_set}"
            )
        if len(free_set) + len(alloc_set) != self.capacity:
            raise AssertionError(
                f"page leak: {self.capacity - len(free_set) - len(alloc_set)} "
                "pages unaccounted for"
            )
        if any(r < 1 for r in self._refs.values()):
            raise AssertionError("non-positive refcount")

    def stats(self) -> Dict[str, float]:
        used = self.used_pages
        return {
            "n_pages": self.capacity,
            "page_size": self.page_size,
            "used_pages": used,
            "free_pages": self.free_pages,
            "occupancy": used / self.capacity if self.capacity else 0.0,
            "shared_pages": self.shared_pages,
            "pages_allocated": self.pages_allocated,
            "pages_freed": self.pages_freed,
            "pages_shared": self.pages_shared,
            "cow_copies": self.cow_copies,
        }
