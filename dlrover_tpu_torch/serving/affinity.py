"""Prefix digests — the digest half of dlrover_tpu/serving/affinity.py,
copied (host-only hashing; the port imports nothing of the JAX
package).

- `prefix_digest_chain(tokens, block)` hashes each block-aligned prefix
  of a prompt into a chained blake2b digest: digest i covers tokens
  [0, (i+1)*block), so two prompts share digest i iff they share that
  exact aligned prefix. The alignment is `RadixPrefixCache.aligned_len`'s
  (floor to `block`), so a digest names a prefix the cache can install.
- `cache_digests(cache)` enumerates the digests of every PUBLISHED
  prefix of a radix cache, newest-touched first, capped.

The host KV tier (serving/kv_tier.py) keys its entries by these
digests. The digest -> replica map and the routing order that read them
belong to the replica pool, which the port does not have yet.
"""

import hashlib
from typing import List, Sequence

DIGEST_BYTES = 8  # 64-bit hex digests: small heartbeats, ~no collisions
# advertisement cap: at most this many published prefixes (the
# newest-touched win, see cache_digests)
MAX_PUBLISHED_DIGESTS = 256


def _block_digest(prev_hex: str, block_tokens: Sequence[int]) -> str:
    h = hashlib.blake2b(digest_size=DIGEST_BYTES)
    h.update(prev_hex.encode())
    for t in block_tokens:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.hexdigest()


def prefix_digest_chain(tokens: Sequence[int], block: int) -> List[str]:
    """Chained digests of every block-aligned prefix of `tokens`:
    element i covers tokens [0, (i+1)*block), so the chain's length is
    aligned_len(len(tokens)) // block."""
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    n = (len(tokens) // block) * block
    chain: List[str] = []
    prev = ""
    for i in range(0, n, block):
        prev = _block_digest(prev, tokens[i:i + block])
        chain.append(prev)
    return chain


def cache_digests(cache, limit: int = MAX_PUBLISHED_DIGESTS) -> List[str]:
    """Digests of the PUBLISHED prefixes of a RadixPrefixCache, one per
    node holding a pool row, by chaining the block edges from the root
    (`published_blocks`). At most `limit`, newest-touched rows first."""
    out: List[str] = []
    for path in cache.published_blocks():
        prev = ""
        for edge in path:
            prev = _block_digest(prev, edge)
        out.append(prev)
        if len(out) >= limit:
            break
    return out
