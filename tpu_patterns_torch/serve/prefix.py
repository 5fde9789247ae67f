"""Host-side radix index over admitted prompts, at block granularity.

Counterpart of ``tpu_patterns/serve/prefix.py`` without its host KV
tier (no host-resident nodes, restores or snapshots; ROADMAP.md).

The paged pool separates logical positions from physical blocks, so
prefix sharing is a question of building tables: two rows whose prompts
agree on positions ``[0, j*BL)`` can map those logical blocks to the
same physical blocks, and the pool holds one copy.  This index finds
those agreements.  It is a radix tree whose edges are whole-block token
tuples: a node at depth ``j`` stands for one physical block holding the
K/V of positions ``[(j-1)*BL, j*BL)`` under the token context of its
path from the root.  K/V at position ``t`` depends on tokens ``[0, t]``
only (causal attention), so a block is reusable by any request whose
first ``j*BL`` tokens equal the node's full path, which is what the
descent checks.

Sharing comes in two grades (``ServeEngine._admit``):

* **alias**: a request matching a node's whole path maps its logical
  block onto the node's physical block (refcount + 1, no new memory);
* **CoW boundary copy**: where the common prefix ends inside a block,
  the block cannot be aliased (the new request writes its own tail into
  it), so the engine copies the best-matching child's block into a
  private one and overwrites it from the split point.

Nodes carry a ``materialized`` flag: a block enters the index at
admission (so requests admitted in the same wave can alias each other;
the batched prefill writes every row before any row attends), but its
contents exist on the device only after that wave's prefill.  A boundary
copy reads the donor outside a prefill call, so only materialized nodes
can donate.

Lifetime is refcount-driven and owned by the engine: when the last row
referencing a block retires, the engine frees it and calls
:meth:`PrefixIndex.remove_block`, so the index describes exactly the
live shareable set.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator


@dataclasses.dataclass
class _Node:
    """One full block: ``key`` is its BL-token tuple, ``block`` the
    physical id, ``parent`` the preceding block's node (or the root)."""

    key: tuple[int, ...]
    block: int
    parent: "_Node | None"
    materialized: bool = False
    children: dict[tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict
    )


@dataclasses.dataclass(frozen=True)
class SharePlan:
    """What the index can do for one prompt: ``aliased`` physical blocks
    covering its first ``len(aliased)`` logical blocks, and an optional
    ``donor`` block for a CoW boundary copy covering ``donor_len`` more
    tokens."""

    aliased: tuple[int, ...] = ()
    donor: int | None = None
    donor_len: int = 0

    def shared_len(self, block_len: int) -> int:
        """Positions whose K/V need not be recomputed."""
        return len(self.aliased) * block_len + self.donor_len


class PrefixIndex:
    """Radix tree over whole-block token tuples -> physical block ids."""

    def __init__(self, block_len: int):
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        self.block_len = block_len
        self.root = _Node(key=(), block=-1, parent=None, materialized=True)
        self._by_block: dict[int, _Node] = {}

    def _full_blocks(self, tokens: list[int]) -> Iterator[tuple[int, ...]]:
        bl = self.block_len
        for j in range(len(tokens) // bl):
            yield tuple(tokens[j * bl : (j + 1) * bl])

    def plan(self, tokens: list[int]) -> SharePlan:
        """The best sharing the index offers ``tokens`` now: descend
        whole-block matches (aliasable whether or not materialized:
        same-wave aliases resolve inside the batched prefill), then look
        among the deepest matched node's materialized children for the
        longest partial-block donor."""
        node = self.root
        aliased: list[int] = []
        for key in self._full_blocks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            aliased.append(child.block)
            node = child
        consumed = len(aliased) * self.block_len
        rest = tuple(tokens[consumed : consumed + self.block_len])
        donor, donor_len = None, 0
        if rest:
            for key, child in node.children.items():
                if not child.materialized:
                    continue
                m = 0
                for a, b in zip(rest, key):
                    if a != b:
                        break
                    m += 1
                if m > donor_len:
                    donor, donor_len = child.block, m
        return SharePlan(aliased=tuple(aliased), donor=donor,
                         donor_len=donor_len)

    def insert(self, tokens: list[int], blocks: list[int]) -> list[int]:
        """Register ``tokens``'s fully covered prompt blocks under the
        physical ids ``blocks`` (the request's table prefix).  Existing
        nodes are kept (they are the aliased blocks); new nodes start
        unmaterialized.  Returns the newly indexed physical ids."""
        node = self.root
        new: list[int] = []
        for j, key in enumerate(self._full_blocks(tokens)):
            child = node.children.get(key)
            if child is None:
                child = _Node(key=key, block=blocks[j], parent=node)
                node.children[key] = child
                self._by_block[child.block] = child
                new.append(child.block)
            node = child
        return new

    def materialize(self, blocks: list[int]) -> None:
        """Mark ``blocks`` as written on the device (their wave's prefill
        ran): they may now donate boundary copies."""
        for b in blocks:
            node = self._by_block.get(b)
            if node is not None:
                node.materialized = True

    def remove_block(self, block: int) -> None:
        """Drop ``block``'s node (its refcount reached zero and the
        engine is freeing it).  Rows referencing a descendant also
        reference every ancestor, so a zero-ref node has only zero-ref
        descendants; within one retire they go in table order, so a
        child may outlive its parent's node for a moment, and the stored
        parent pointer keeps the unlink well defined."""
        node = self._by_block.pop(block, None)
        if node is None:
            return
        if node.parent is not None and node.parent.children.get(
            node.key
        ) is node:
            del node.parent.children[node.key]

    def __len__(self) -> int:
        return len(self._by_block)

    def blocks(self) -> set[int]:
        return set(self._by_block)
