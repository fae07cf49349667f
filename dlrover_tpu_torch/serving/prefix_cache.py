"""Host-side radix index over block-quantized prompt prefixes — the
port's own copy of dlrover_tpu/serving/prefix_cache.py (pure Python, no
device traffic; the port imports nothing from the JAX package).

The admission-time prefix cache (serving/engine.py) splits in two:

- DEVICE: a prefix pool, a second KV bank beside the slot bank (or the
  page pool), one full-length EXACT row per cached prefix. Rows are
  written once at publish time and read whole at install time.
- HOST: this radix tree, the only thing that knows which pool row holds
  which token prefix.

Token prefixes are quantized to `block` tokens: every tree edge is one
block, so a lookup costs O(prefix / block) tuple hashes and a prompt
matches only at block-aligned lengths.

Eviction is LRU over UNREFERENCED rows: a row acquired by a live slot
(its admission installed from it and the request is in flight) is
pinned until `release()`. The paged engine shares the published pages
of a row copy-free, so there the pin is what keeps a live slot's pages
from being freed under it.
"""

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class _Node:
    """One radix node = one block-aligned prefix. `row` is the pool row
    holding K/V for positions [0, depth), or None for an interior node
    (a longer prefix was published through here)."""

    __slots__ = ("children", "parent", "edge", "depth", "row")

    def __init__(self, parent=None, edge=None, depth=0):
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.edge = edge          # block tuple keying us in parent
        self.depth = depth        # prefix length in TOKENS
        self.row: Optional[int] = None


class RadixPrefixCache:
    """Radix-matched prefix -> pool-row index, ref-counted LRU.

    Pure host bookkeeping: the engine owns the device pool and calls
    match / insert / acquire / release; the rows handed out here are
    its row indices there."""

    def __init__(
        self,
        n_rows: int,
        block: int = 16,
        on_evict: Optional[
            Callable[[int, List[Tuple[int, ...]]], None]
        ] = None,
    ):
        if n_rows < 1:
            raise ValueError(f"n_rows must be >= 1, got {n_rows}")
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.n_rows = n_rows
        self.block = block
        # fired with (row, block-edge path) whenever a row leaves the
        # tree: the paged engine drops the published page run's
        # references there, so an evicted prefix cannot leak pool
        # pages, and the host tier (serving/kv_tier.py) keys the
        # demoted K/V by the path's digest before the bytes are dropped
        self.on_evict = on_evict
        self.root = _Node()
        self._row_node: Dict[int, _Node] = {}
        self._free: List[int] = list(range(n_rows))
        # insertion / touch order = LRU order (oldest first)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._refs: Dict[int, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_reused = 0

    # ---- lookup ----------------------------------------------------------

    def aligned_len(self, n: int) -> int:
        """Longest block-aligned prefix length of an n-token prompt."""
        return (n // self.block) * self.block

    def _block_key(self, tokens, i: int) -> Tuple[int, ...]:
        return tuple(int(t) for t in tokens[i : i + self.block])

    def match(self, tokens: Sequence[int]) -> Tuple[int, Optional[int]]:
        """Longest block-aligned cached prefix of `tokens` ->
        (matched_len, pool_row); (0, None) on a miss. The matched row is
        touched in LRU order but NOT acquired."""
        node = self.root
        best_len, best_row = 0, None
        n = self.aligned_len(len(tokens))
        for i in range(0, n, self.block):
            child = node.children.get(self._block_key(tokens, i))
            if child is None:
                break
            node = child
            if node.row is not None:
                best_len, best_row = node.depth, node.row
        if best_row is not None:
            self._lru.move_to_end(best_row)
        return best_len, best_row

    # ---- ref counting ----------------------------------------------------

    def acquire(self, row: int) -> None:
        """Pin a row while a live slot depends on it."""
        if row not in self._row_node:
            raise KeyError(f"row {row} is not allocated")
        self._refs[row] = self._refs.get(row, 0) + 1

    def release(self, row: int) -> None:
        n = self._refs.get(row, 0)
        if n <= 0:
            raise ValueError(f"release of unreferenced row {row}")
        if n == 1:
            del self._refs[row]
        else:
            self._refs[row] = n - 1

    def refcount(self, row: int) -> int:
        return self._refs.get(row, 0)

    # ---- publish ---------------------------------------------------------

    def insert(self, tokens: Sequence[int]) -> Tuple[Optional[int], bool]:
        """Claim a pool row for the (block-aligned) prefix `tokens`.

        (row, True): the caller must now write the K/V into that row
        (the tree records the mapping first). (row, False): the exact
        prefix is cached already. (None, False): every row is pinned,
        nothing can be evicted; the caller skips publishing."""
        n = self.aligned_len(len(tokens))
        if n < self.block:
            return None, False
        node = self.root
        for i in range(0, n, self.block):
            key = self._block_key(tokens, i)
            child = node.children.get(key)
            if child is None:
                child = _Node(
                    parent=node, edge=key, depth=node.depth + self.block
                )
                node.children[key] = child
            node = child
        if node.row is not None:
            self._lru.move_to_end(node.row)
            return node.row, False
        # reserve the target before allocating: _alloc may evict a
        # descendant's row, and its _prune must not detach THIS (still
        # rowless) node when that was its last child
        node.row = -1
        row = self._alloc()
        node.row = None
        if row is None:
            self._prune(node)
            return None, False
        node.row = row
        self._row_node[row] = node
        self._lru[row] = None
        return row, True

    def _alloc(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        for row in self._lru:  # oldest-touched first
            if self._refs.get(row, 0) == 0:
                self._evict(row)
                return row
        return None

    def evict_lru(self) -> bool:
        """Force out the oldest unreferenced row and return it to the
        free list; False when every row is pinned. The paged engine
        calls this under page-pool pressure: dropping a published
        prefix run is cheaper than preempting a live request."""
        for row in self._lru:  # oldest-touched first
            if self._refs.get(row, 0) == 0:
                self._evict(row)
                self._free.append(row)
                return True
        return False

    def _evict(self, row: int) -> None:
        if self._refs.get(row, 0):
            raise AssertionError(f"evicting row {row} with live references")
        node = self._row_node.pop(row)
        node.row = None
        del self._lru[row]
        self.evictions += 1
        # the edge path BEFORE pruning detaches the chain
        blocks = self._path(node) if self.on_evict is not None else []
        self._prune(node)
        if self.on_evict is not None:
            self.on_evict(row, blocks)

    @staticmethod
    def _path(node: _Node) -> List[Tuple[int, ...]]:
        """The block edges from the root down to `node`."""
        path: List[Tuple[int, ...]] = []
        while node.parent is not None:
            path.append(node.edge)
            node = node.parent
        path.reverse()
        return path

    @staticmethod
    def _prune(node: _Node) -> None:
        """Drop rowless leaf chains so a churned tree stays O(rows)."""
        while (
            node.parent is not None
            and node.row is None
            and not node.children
        ):
            parent = node.parent
            del parent.children[node.edge]
            node = parent

    # ---- accounting ------------------------------------------------------

    def record_admission(self, reused_tokens: int) -> None:
        """One admission's outcome: reused_tokens > 0 is a hit."""
        if reused_tokens > 0:
            self.hits += 1
            self.tokens_reused += reused_tokens
        else:
            self.misses += 1

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "tokens_reused": self.tokens_reused,
            "hit_rate": self.hit_rate(),
            "rows_used": len(self._row_node),
            "rows_total": self.n_rows,
        }

    # ---- enumeration -----------------------------------------------------

    def published_blocks(self):
        """Yield the block-edge path (root -> node, one block tuple per
        edge) of every PUBLISHED prefix, newest-touched first: what
        affinity.cache_digests hashes into advertised digests."""
        # snapshot the LRU order first: a reader may walk this while
        # the engine publishes or evicts
        for row in reversed(list(self._lru)):
            node = self._row_node.get(row)
            if node is None:  # torn iteration under churn: skip
                continue
            yield self._path(node)
