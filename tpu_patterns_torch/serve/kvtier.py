"""Host KV tier: host copies of cold blocks behind the paged device pool.

Counterpart of ``tpu_patterns/serve/kvtier.py``.  A pool sized for chat
traffic cannot hold every conversation's blocks on the device.  Without
a tier the engine meets a dry free list only by deferring admission;
with one, the admission ladder is alias -> **evict** -> defer: cold
radix-index blocks move to host memory when the free list runs dry and
page back on a prefix hit, so memory pressure costs copies instead of
recomputed prefixes.

The handoff happens at block granularity only, through the decoder's
``gather_blocks``/``onload_blocks`` (``serve/paged.py``), and a block is
either device-resident (a physical pool id, attended through tables) or
host-resident (a tier handle, invisible to attention), never both.

Persistence (the session cache) rides ``ckpt/checkpoint.py``'s atomic
commit: each eviction wave that must survive a crash commits the whole
tier, block contents as tensor leaves and the radix paths as a
``session.json`` sidecar in the same commit, under ``session_dir``.  A
crash mid-evict leaves either the device-resident state (the engine
mutates its state only after the commit) or the previously committed
host copy.  A restarted engine reloads the committed tier, so a resumed
conversation re-admits with zero fresh prefill blocks for its history.

One difference from the reference: its store holds numpy arrays, and
numpy has no bfloat16, so this one holds CPU ``torch.Tensor``s and
``leaf_meta`` names torch dtypes (the checkpoint keeps bfloat16 as
bytes).  The host copies are in pageable memory; pinned staging with
asynchronous copies is a later performance item (ROADMAP.md).
"""

from __future__ import annotations

import json
import math

import torch

from tpu_patterns_torch import ckpt
from tpu_patterns_torch.ckpt.checkpoint import _dtype_name

# the session cache's own format: the radix paths ride beside the
# blocks, and a session committed under another format or fingerprint
# is refused rather than resumed with absent blocks
SESSION_FORMAT = 2


class HostTier:
    """Host-side block store keyed by integer handles.

    ``leaf_meta`` maps pool leaf names to ``(block_shape, dtype)``, where
    ``block_shape`` is the pool leaf's shape without the block axis, e.g.
    ``(depth, block_len, Hkv, D)``.

    ``capacity_blocks`` bounds host memory (0 = unbounded): the engine
    drops the least-recently-stored handle past the cap, and a forgotten
    prefix prefills again."""

    def __init__(
        self,
        leaf_meta: dict[str, tuple[tuple, torch.dtype]],
        *,
        block_len: int,
        session_dir: str | None = None,
        capacity_blocks: int = 0,
        fingerprint: dict | None = None,
    ):
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        if capacity_blocks < 0:
            raise ValueError(
                f"capacity_blocks must be >= 0, got {capacity_blocks}"
            )
        self.leaf_meta = {
            name: (tuple(shape), dt) for name, (shape, dt) in leaf_meta.items()
        }
        self.block_len = block_len
        self.session_dir = session_dir or None
        self.capacity_blocks = capacity_blocks
        self.fingerprint = dict(fingerprint or {})
        # handle -> {leaf name: CPU tensor}; dict order is the
        # least-recently-stored order the capacity bound drops from
        self.store: dict[int, dict[str, torch.Tensor]] = {}
        # handle -> the block's radix path (token ids from the root)
        self.paths: dict[int, tuple[int, ...]] = {}
        self._next_handle = 0
        self._commit_step = 0

    # -- in-memory store -------------------------------------------------

    def block_nbytes(self) -> int:
        """Host bytes one block takes (every leaf)."""
        return sum(
            math.prod(shape) * torch.empty((), dtype=dt).element_size()
            for shape, dt in self.leaf_meta.values()
        )

    def put(self, data: dict[str, torch.Tensor],
            path: tuple[int, ...]) -> int:
        """Store one block's leaves (copied: callers pass slices of a
        gathered wave, and a view would keep the whole wave alive);
        returns the tier handle."""
        if set(data) != set(self.leaf_meta):
            raise ValueError(
                f"tier block leaves {sorted(data)} != pool leaves "
                f"{sorted(self.leaf_meta)}"
            )
        block = {}
        for name, t in data.items():
            shape, dt = self.leaf_meta[name]
            if tuple(t.shape) != shape:
                raise ValueError(
                    f"tier block leaf {name}: shape {tuple(t.shape)} "
                    f"!= declared {shape}"
                )
            block[name] = t.to(device="cpu", dtype=dt,
                               copy=True).contiguous()
        h = self._next_handle
        self._next_handle += 1
        self.store[h] = block
        self.paths[h] = tuple(int(t) for t in path)
        return h

    def get(self, handle: int) -> dict[str, torch.Tensor]:
        return self.store[handle]

    def discard(self, handle: int) -> None:
        self.store.pop(handle, None)
        self.paths.pop(handle, None)

    def oldest(self) -> int | None:
        """Least-recently-stored handle (the capacity-drop victim)."""
        return next(iter(self.store), None)

    def over_capacity(self) -> bool:
        return 0 < self.capacity_blocks < len(self.store)

    def __len__(self) -> int:
        return len(self.store)

    # -- engine-snapshot interchange -------------------------------------

    def state_arrays(self) -> tuple[list[int], dict[str, torch.Tensor]]:
        """(handles, stacked tensors): the tier's contents as one tensor
        a leaf, in handle order, for a checkpoint tree."""
        handles = sorted(self.store)
        arrays = {
            name: torch.stack([self.store[h][name] for h in handles])
            if handles else torch.zeros((0, *shape), dtype=dt)
            for name, (shape, dt) in self.leaf_meta.items()
        }
        return handles, arrays

    def load_arrays(self, handles: list[int],
                    paths: dict[int, tuple[int, ...]],
                    arrays: dict[str, torch.Tensor]) -> None:
        """Rebuild the store from :meth:`state_arrays` output (each block
        copied out of the stacked tensors)."""
        self.store.clear()
        self.paths.clear()
        for i, h in enumerate(handles):
            self.store[int(h)] = {
                name: arrays[name][i].clone() for name in self.leaf_meta
            }
            self.paths[int(h)] = tuple(int(t) for t in paths[h])
        self._next_handle = max(
            [self._next_handle] + [int(h) + 1 for h in handles]
        )

    # -- the session cache -----------------------------------------------

    def commit(self) -> str | None:
        """Commit the whole tier atomically under ``session_dir`` (no-op
        without one): the block tensors through ``ckpt.save``, the radix
        paths, leaf table and fingerprint in its ``session.json`` sidecar,
        so a crash at any point leaves the previous committed session.
        Each commit rewrites the whole tier, O(stored blocks) a wave, as
        the reference does."""
        if not self.session_dir:
            return None
        handles, arrays = self.state_arrays()
        meta = {
            "format": SESSION_FORMAT,
            "fingerprint": self.fingerprint,
            "block_len": self.block_len,
            "handles": handles,
            "paths": {str(h): list(self.paths[h]) for h in handles},
            "leaves": {
                name: {"shape": list(shape), "dtype": _dtype_name(dt)}
                for name, (shape, dt) in self.leaf_meta.items()
            },
        }
        self._commit_step += 1
        # keep=2: the previous session survives until this commit lands
        return ckpt.save(
            self.session_dir, self._commit_step, arrays,
            extras={"session.json": json.dumps(meta)}, keep=2,
        )

    def load_session(self) -> list[tuple[tuple[int, ...], int]]:
        """Load the latest committed session into the store; returns
        ``[(path, handle), ...]`` shallow-first, so the caller rebuilds
        host-resident index nodes parent before child.  A missing or
        empty session dir gives ``[]``; a session committed under another
        format, fingerprint or leaf table raises."""
        if not self.session_dir:
            return []
        step = ckpt.latest_step(self.session_dir)
        if step is None:
            return []
        meta = json.loads(
            ckpt.read_extra(self.session_dir, "session.json", step=step)
        )
        if meta.get("format") != SESSION_FORMAT:
            raise ValueError(
                f"session cache format {meta.get('format')} != "
                f"{SESSION_FORMAT} under {self.session_dir}"
            )
        if (self.fingerprint and meta.get("fingerprint")
                and meta["fingerprint"] != self.fingerprint):
            diff = {
                k for k in set(self.fingerprint) | set(meta["fingerprint"])
                if self.fingerprint.get(k) != meta["fingerprint"].get(k)
            }
            raise ValueError(
                "session cache was committed under a different "
                f"pool/model config (mismatched: {sorted(diff)}): point "
                "--session_dir at a fresh directory or rerun with the "
                "original flags"
            )
        saved = {
            name: (tuple(info["shape"]), info["dtype"])
            for name, info in meta["leaves"].items()
        }
        mine = {name: (shape, _dtype_name(dt))
                for name, (shape, dt) in self.leaf_meta.items()}
        if saved != mine:
            raise ValueError(
                f"session cache leaf table {saved} != pool leaf table "
                f"{mine}"
            )
        handles = [int(h) for h in meta["handles"]]
        template = {
            name: torch.empty((len(handles), *shape), dtype=dt)
            for name, (shape, dt) in self.leaf_meta.items()
        }
        arrays = ckpt.restore(self.session_dir, template, step=step)
        paths = {
            h: tuple(int(t) for t in meta["paths"][str(h)]) for h in handles
        }
        self.load_arrays(handles, paths, arrays)
        self._commit_step = step
        return sorted(
            ((self.paths[h], h) for h in handles),
            key=lambda e: (len(e[0]), e[0]),
        )
