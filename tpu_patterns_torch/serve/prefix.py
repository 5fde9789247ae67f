"""Host-side radix index over admitted prompts, at block granularity.

Counterpart of ``tpu_patterns/serve/prefix.py`` (a copy: the reference
module is jax-free).

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

With the host KV tier on (``serve/kvtier.py``) a node has a third state
beyond live and gone: **host-resident**.  A retained (refcount-0) block
evicted under memory pressure keeps its node, which then carries a tier
``host`` handle instead of a physical ``block`` id (exactly one of the
two at any time).  :meth:`plan` reports the host-resident continuation
of the matched path as ``restores``; the engine pages them back onto
fresh physical blocks (:meth:`restore_block`) when an admission wants
them.  Eviction is leaf-first (a node may go to host only when it has no
device-resident child, :meth:`has_resident_children`), so shared prefix
roots stay on the device as long as anything below them does.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator


@dataclasses.dataclass
class _Node:
    """One full block: ``key`` is its BL-token tuple, ``block`` the
    physical id, ``parent`` the preceding block's node (or the root).
    A host-resident node has ``block == -1`` and ``host`` set to its
    tier handle."""

    key: tuple[int, ...]
    block: int
    parent: "_Node | None"
    materialized: bool = False
    host: int | None = None
    children: dict[tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict
    )


@dataclasses.dataclass(frozen=True)
class SharePlan:
    """What the index can do for one prompt: ``aliased`` physical blocks
    covering its first ``len(aliased)`` logical blocks, then (kv tier
    only) ``restores``, tier handles of the host-resident run that
    continues the device-resident prefix, and an optional ``donor``
    block for a CoW boundary copy covering ``donor_len`` more tokens."""

    aliased: tuple[int, ...] = ()
    donor: int | None = None
    donor_len: int = 0
    restores: tuple[int, ...] = ()

    def shared_len(self, block_len: int) -> int:
        """Positions whose K/V need not be recomputed."""
        return (
            (len(self.aliased) + len(self.restores)) * block_len
            + self.donor_len
        )


class PrefixIndex:
    """Radix tree over whole-block token tuples -> physical block ids."""

    def __init__(self, block_len: int):
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        self.block_len = block_len
        self.root = _Node(key=(), block=-1, parent=None, materialized=True)
        self._by_block: dict[int, _Node] = {}
        self._by_handle: dict[int, _Node] = {}

    # -- queries ---------------------------------------------------------

    def _full_blocks(self, tokens: list[int]) -> Iterator[tuple[int, ...]]:
        bl = self.block_len
        for j in range(len(tokens) // bl):
            yield tuple(tokens[j * bl : (j + 1) * bl])

    def plan(self, tokens: list[int]) -> SharePlan:
        """The best sharing the index offers ``tokens`` now: descend
        whole-block matches (aliasable whether or not materialized:
        same-wave aliases resolve inside the batched prefill), then the
        host-resident run continuing that device prefix, then look among
        the deepest matched node's materialized device children for the
        longest partial-block donor.  Descent stops at a device node
        below a host one: a table may hold no gap."""
        node = self.root
        aliased: list[int] = []
        restores: list[int] = []
        consumed = 0
        for key in self._full_blocks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            if child.host is not None:
                restores.append(child.host)
            elif restores:
                break  # device below host: the restore run ended
            else:
                aliased.append(child.block)
            consumed += self.block_len
            node = child
        rest = tuple(tokens[consumed : consumed + self.block_len])
        donor, donor_len = None, 0
        if rest:
            for key, child in node.children.items():
                if not child.materialized or child.host is not None:
                    continue
                m = 0
                for a, b in zip(rest, key):
                    if a != b:
                        break
                    m += 1
                if m > donor_len:
                    donor, donor_len = child.block, m
        return SharePlan(aliased=tuple(aliased), donor=donor,
                         donor_len=donor_len, restores=tuple(restores))

    # -- mutation --------------------------------------------------------

    def insert(self, tokens: list[int], blocks: list[int]) -> list[int]:
        """Register ``tokens``'s fully covered prompt blocks under the
        physical ids ``blocks`` (the request's table prefix).  Existing
        nodes are kept (they are the aliased blocks); new nodes start
        unmaterialized.  Descent stops at a host-resident node (a failed
        onload leaves one mid-path): a device block under a host parent
        would break the leaf-first shape, so that row's private tail
        goes unindexed.  Returns the newly indexed physical ids."""
        node = self.root
        new: list[int] = []
        for j, key in enumerate(self._full_blocks(tokens)):
            child = node.children.get(key)
            if child is not None and child.host is not None:
                break
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

    # -- host-tier state transitions (serve/kvtier.py) -------------------

    def has_resident_children(self, block: int) -> bool:
        """Whether ``block``'s node still has a device-resident child:
        leaf-first eviction's guard."""
        node = self._by_block.get(block)
        if node is None:
            return False
        return any(c.host is None for c in node.children.values())

    def evict_block(self, block: int, handle: int) -> None:
        """Move ``block``'s node to host-resident under tier ``handle``
        (the engine committed the host copy and frees the block)."""
        node = self._by_block.pop(block)
        node.block = -1
        node.host = handle
        self._by_handle[handle] = node

    def restore_block(self, handle: int, block: int) -> None:
        """Page ``handle``'s node back onto physical ``block`` (the
        engine onloaded the host copy into it)."""
        node = self._by_handle.pop(handle)
        node.host = None
        node.block = block
        self._by_block[block] = node

    def is_materialized(self, block: int) -> bool:
        """Whether ``block`` is indexed and its wave's prefill ran: the
        retention predicate."""
        node = self._by_block.get(block)
        return node is not None and node.materialized

    def _unlink_subtree(self, node: _Node) -> list[int]:
        """Unlink ``node`` from its parent and drop every host-resident
        descendant from the handle map (no device descendant can sit
        below a droppable node: leaf-first); returns the descendant
        handles so the caller can release their tier copies."""
        dropped: list[int] = []

        def drop(n: _Node) -> None:
            for c in n.children.values():
                if c.host is not None:
                    self._by_handle.pop(c.host, None)
                    dropped.append(c.host)
                drop(c)

        drop(node)
        if node.parent is not None and node.parent.children.get(
            node.key
        ) is node:
            del node.parent.children[node.key]
        return dropped

    def remove_handle(self, handle: int) -> list[int]:
        """Drop a host-resident node (a tier capacity drop) with its
        host-resident subtree, which no plan could reach again.  Returns
        the descendant handles dropped alongside."""
        node = self._by_handle.pop(handle, None)
        if node is None:
            return []
        return self._unlink_subtree(node)

    def drop_block_subtree(self, block: int) -> list[int]:
        """Remove ``block``'s node like :meth:`remove_block`, and unlink
        its host-resident descendants too (a discarded retained block
        may have evicted children); returns their handles."""
        node = self._by_block.pop(block, None)
        if node is None:
            return []
        return self._unlink_subtree(node)

    def node_path(self, block: int) -> tuple[int, ...]:
        """``block``'s full token path from the root: the content
        identity the session cache persists."""
        node = self._by_block[block]
        path: list[int] = []
        while node is not self.root:
            path[:0] = node.key
            node = node.parent
        return tuple(path)

    def add_host_path(self, tokens: tuple[int, ...], handle: int) -> bool:
        """Rebuild one host-resident node from a session-cache entry
        (``tokens``: its full path).  Every ancestor must exist already
        (entries load shallow-first); an orphan or a duplicate returns
        False, so a partly persisted chain never fabricates coverage."""
        if len(tokens) % self.block_len or not tokens:
            return False
        node = self.root
        keys = list(self._full_blocks(list(tokens)))
        for key in keys[:-1]:
            node = node.children.get(key)
            if node is None:
                return False
        leaf_key = keys[-1]
        if leaf_key in node.children:
            return False
        child = _Node(key=leaf_key, block=-1, parent=node,
                      materialized=True, host=handle)
        node.children[leaf_key] = child
        self._by_handle[handle] = child
        return True

    # -- accounting and snapshot -----------------------------------------

    def __len__(self) -> int:
        return len(self._by_block)

    def blocks(self) -> set[int]:
        return set(self._by_block)

    def host_handles(self) -> set[int]:
        return set(self._by_handle)

    def to_state(self) -> list:
        """JSON-friendly nested encoding (preorder, exact round trip):
        snapshot format 2, ``[key, block, materialized, children]`` a
        node, with the tier handle as a fifth element on host-resident
        nodes only."""

        def enc(node: _Node) -> list:
            out = [
                list(node.key),
                node.block,
                bool(node.materialized),
                [enc(c) for _, c in sorted(node.children.items())],
            ]
            if node.host is not None:
                out.append(node.host)
            return out

        return [enc(c) for _, c in sorted(self.root.children.items())]

    @classmethod
    def from_state(cls, block_len: int, state: list) -> "PrefixIndex":
        idx = cls(block_len)

        def dec(parent: _Node, enc: list) -> None:
            key, block, materialized, children = enc[:4]
            host = enc[4] if len(enc) > 4 else None
            node = _Node(
                key=tuple(int(t) for t in key),
                block=int(block),
                parent=parent,
                materialized=bool(materialized),
                host=int(host) if host is not None else None,
            )
            parent.children[node.key] = node
            if node.host is not None:
                idx._by_handle[node.host] = node
            else:
                idx._by_block[node.block] = node
            for c in children:
                dec(node, c)

        for c in state:
            dec(idx.root, c)
        return idx
