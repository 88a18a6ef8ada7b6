"""Radix (token-trie) prefix cache: prompt prefixes -> frozen KV block
chains (host-side).

The port's own copy of ``bpe_transformer_tpu/serving/kvpool/radix.py``
(the two packages share no module).

One trie node per FULL prompt block (``block_size`` tokens): the edge key
is the block's token tuple, the node's value its pool block id.  A new
request walks the trie block-by-block over its prompt; every matched node
is a prefill it never has to run — the engine refs the block into the
slot's block table and starts computing at the first unmatched position.
After a prefill completes, the prompt's full blocks are inserted so the
NEXT request with the same prefix hits.

Only fully-written prompt blocks are indexed (a partial tail block is
still written by its owner's decode steps, so it can never be shared),
which is what makes matched blocks frozen and sharing copy-on-write by
construction — see `blocks.py`.

The cache holds one allocator reference per indexed block, so indexed
blocks survive their original request.  When the pool runs dry the engine
calls :meth:`evict`: least-recently-used LEAF nodes whose block nobody
else references are dropped first (an interior node's block is still the
prefix of a live chain — evicting leaves first keeps every remaining
chain walkable).
"""

from __future__ import annotations

from bpe_transformer_tpu_torch.serving.kvpool.blocks import BlockAllocator


class _Node:
    __slots__ = ("block_id", "children", "parent", "key", "stamp")

    def __init__(self, block_id: int, parent, key):
        self.block_id = block_id
        self.parent = parent
        self.key = key  # the token tuple of this block (edge from parent)
        self.children: dict[tuple, _Node] = {}
        self.stamp = 0  # LRU clock value of the last match/insert touch


class RadixPrefixCache:
    """Token-trie over full prompt blocks (see module docstring)."""

    def __init__(self, allocator: BlockAllocator):
        self._allocator = allocator
        self._root = _Node(block_id=-1, parent=None, key=None)
        self._clock = 0
        self._nodes = 0
        self.hits_tokens = 0
        self.misses_tokens = 0

    def __len__(self) -> int:
        return self._nodes

    # -------------------------------------------------------------- lookup

    def match(self, prompt: list[int]) -> list[int]:
        """Longest indexed prefix of ``prompt`` in full blocks: returns the
        matched block ids (allocator-ref'd for the caller — the caller owns
        releasing them).

        The match is capped at ``len(prompt) - 1`` tokens: at least one
        prompt position must be computed so the admission has logits to
        sample its first token from (a fully-cached prompt still needs its
        last position's forward).

        Deliberately does NOT touch the hit/miss counters: a block-starved
        admission is matched again on every retry, and charging lookups
        rather than admissions would inflate the hit rate with phantom
        tokens — the engine calls :meth:`charge` once per admission that
        actually proceeds.
        """
        bs = self._allocator.block_size
        matched: list[int] = []
        node = self._root
        self._clock += 1
        pos = 0
        # pos + bs <= len(prompt) - 1: the matched region always leaves at
        # least the last prompt token uncached (see docstring).
        while pos + bs <= len(prompt) - 1:
            key = tuple(prompt[pos: pos + bs])
            child = node.children.get(key)
            if child is None:
                break
            child.stamp = self._clock
            matched.append(child.block_id)
            node = child
            pos += bs
        if matched:
            self._allocator.ref(matched)
        return matched

    def charge(self, prompt_len: int, hit_tokens: int) -> None:
        """Account one ADMITTED prompt against the hit/miss counters:
        ``hit_tokens`` of its ``prompt_len`` were served from the cache."""
        self.hits_tokens += hit_tokens
        self.misses_tokens += prompt_len - hit_tokens

    # -------------------------------------------------------------- insert

    def insert(self, prompt: list[int], block_ids: list[int]) -> int:
        """Index ``prompt``'s full blocks under their pool block ids;
        returns how many NEW nodes were created (each new node takes one
        allocator reference).  Existing nodes keep their original block id
        — two racing identical prefills simply miss the dedup for the
        second one."""
        bs = self._allocator.block_size
        full = min(len(prompt) // bs, len(block_ids))
        node = self._root
        created = 0
        self._clock += 1
        for i in range(full):
            key = tuple(prompt[i * bs: (i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _Node(block_ids[i], parent=node, key=key)
                node.children[key] = child
                self._allocator.ref([block_ids[i]])
                self._nodes += 1
                created += 1
            child.stamp = self._clock
            node = child
        return created

    # ------------------------------------------------------------ eviction

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` pool blocks by dropping LRU leaf nodes
        whose block has no reference besides the cache's own.  Returns how
        many blocks were actually freed.

        One DFS per WAVE, not per block: each pass collects every
        currently-evictable leaf, evicts them oldest-stamp-first, and only
        rescans when more blocks are still needed (evicting a leaf can
        turn its parent into the next wave's candidate) — so a
        multi-block shortfall on a large trie costs O(depth) scans, not
        O(shortfall) scans."""
        freed = 0
        while freed < n_blocks:
            victims = []
            stack = [self._root]
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if (
                    node is not self._root
                    and not node.children
                    and self._allocator.refcount(node.block_id) == 1
                ):
                    victims.append(node)
            if not victims:
                break
            victims.sort(key=lambda node: node.stamp)
            for victim in victims:
                if freed >= n_blocks:
                    break
                del victim.parent.children[victim.key]
                self._nodes -= 1
                freed += self._allocator.deref([victim.block_id])
        return freed

    def gauges(self) -> dict:
        total = self.hits_tokens + self.misses_tokens
        return {
            "prefix_cache_hits": self.hits_tokens,
            "prefix_cache_misses": self.misses_tokens,
            "prefix_hit_rate": (
                round(self.hits_tokens / total, 6) if total else None
            ),
            "prefix_cache_nodes": self._nodes,
        }
