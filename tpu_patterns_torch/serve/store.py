"""Fleet-scoped shared prefix store: crash-consistent KV migration.

The port's copy of ``tpu_patterns/serve/store.py``, on the same on-disk
layout: one ``<fingerprint>.npz`` a block, its leaves as npz members
beside the JSON ``_meta`` member.  As in ``serve/kvtier.py`` the
payloads are CPU ``torch.Tensor``s and ``leaf_meta`` names torch dtypes,
because numpy has no bfloat16: a bfloat16 leaf is written as the raw
two-byte void members the JAX package writes for it, and read back by
its dtype in the meta.  A store that either package publishes loads in
the other.

The session cache makes ONE engine's prefixes survive ITS restart;
every replica's radix cache and host tier stays private.  This module
is the fleet-scoped promotion: a shared directory any replica publishes
retained/evicted full prefix blocks into and any replica consults on an
admission miss — so a fail-over reroute lands on a sibling that can
fetch the dead replica's warm history instead of re-prefilling it, and
a scale-out replica pre-warms its ring arc before its first request.

One entry per block, named by the block's **fingerprint** — SHA-256
over the full root→node token path, the same hashing discipline the
router applies to its first ``route_blocks`` blocks (serve/router.py),
extended to the whole path so every depth keys uniquely.  Entry
contents are the block's pool leaves (unsharded global per-block
shapes, exactly the HostTier layout) plus a JSON meta member carrying
the store format, the pool/model config fingerprint, the path itself,
the leaf table, and a payload digest.

The commit protocol is ``ckpt/``'s: write the whole entry to a
uniquely named ``*.tmp`` sibling (pid + per-process sequence, so
concurrent publishers never collide), then ``os.replace`` onto the
final name.  The rename is atomic, so concurrent publishers are
last-commit-wins and a reader opens EITHER a complete previous entry
or a complete new one — never a torn block.  Fetch re-derives the
payload digest and loud-rejects foreign-fingerprint or corrupt entries
(the session cache's discipline: recompute, never resume wrong bytes).

The store is an OPTIMIZATION plane: every consumer degrades to fresh
prefill on miss or failure (``store.publish`` / ``store.fetch`` /
``store.prewarm`` fault sites in the engine), so nothing here is ever
load-bearing for correctness — and never load-bearing for WRONGNESS
either: round-trips are bit-identical (int8 scale planes included) or
they are refused.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import zipfile

import numpy as np
import torch

from tpu_patterns_torch.ckpt.checkpoint import _dtype_name, _torch_dtype

STORE_FORMAT = 1

# the JSON meta member's name inside each entry — reserved, so a pool
# leaf could never shadow it
META_MEMBER = "_meta"

# tmp-name uniqueness within one process (itertools.count.__next__ is
# atomic under the GIL); the pid component covers cross-process
_TMP_SEQ = itertools.count()


def block_fingerprint(path) -> str:
    """The store key for one block: SHA-256 over the repr of its full
    root→node token path — the radix scheme the router already hashes
    (serve/router.py ``prefix_fingerprint``), taken to full depth so
    a parent and child never collide."""
    return hashlib.sha256(
        repr(tuple(int(t) for t in path)).encode()
    ).hexdigest()


def leaf_to_numpy(t: torch.Tensor, dt: torch.dtype) -> np.ndarray:
    """A leaf's C-order host array for the npz member: its own numpy
    dtype, or for bfloat16 (which numpy lacks) the raw two-byte void
    array the JAX package's ``np.savez`` of a bfloat16 array writes."""
    t = t.to(device="cpu", dtype=dt).contiguous()
    if dt == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def leaf_from_numpy(arr: np.ndarray, dt: torch.dtype) -> torch.Tensor:
    """An npz member back as a CPU tensor of the meta's dtype (a
    bfloat16 leaf is read back from its raw bytes)."""
    arr = np.ascontiguousarray(arr)
    if dt == torch.bfloat16:
        if arr.dtype.itemsize != 2:
            raise ValueError(
                f"bfloat16 leaf stored as {arr.dtype} ({arr.dtype.itemsize}"
                " bytes an element)"
            )
        return torch.from_numpy(arr.view(np.int16).copy()).view(dt)
    if arr.dtype != np.dtype(_dtype_name(dt)):
        raise ValueError(f"leaf stored as {arr.dtype}, meta says {dt}")
    return torch.from_numpy(arr.copy())


def _payload_digest(data: dict[str, np.ndarray]) -> str:
    """Content digest over every leaf's C-order bytes, name-sorted —
    what fetch re-derives to refuse corrupt entries."""
    h = hashlib.sha256()
    for name in sorted(data):
        h.update(name.encode())
        h.update(np.ascontiguousarray(data[name]).tobytes())
    return h.hexdigest()


def scan(root: str, fingerprint: dict | None = None):
    """Every committed entry under ``root`` as ``(path, stamp)``,
    sorted shallow-first (parents before children — the adoption
    order ``PrefixIndex.add_host_path`` needs), ``stamp`` the entry's
    mtime in ns (most-recently-published = hottest, the pre-warm
    ranking).  Advisory by design: entries under a foreign config
    fingerprint and unreadable files are SKIPPED here — fetch is the
    loud path.  A missing directory is an empty store."""
    out: list[tuple[tuple[int, ...], int]] = []
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    for fn in names:
        if not fn.endswith(".npz"):
            continue  # in-flight *.tmp siblings are not entries
        full = os.path.join(root, fn)
        try:
            with np.load(full) as z:
                meta = json.loads(bytes(z[META_MEMBER]).decode())
            stamp = os.stat(full).st_mtime_ns
        # the advisory plane (pre-warm ranking): a foreign or vanishing
        # file is skipped, fetch stays the loud path
        except Exception:
            continue
        if meta.get("format") != STORE_FORMAT:
            continue
        if (
            fingerprint
            and meta.get("fingerprint")
            and meta["fingerprint"] != fingerprint
        ):
            continue
        out.append((tuple(int(t) for t in meta["path"]), stamp))
    return sorted(out, key=lambda e: (len(e[0]), e[0]))


class PrefixStore:
    """Directory-backed fleet prefix store (one process's handle).

    ``leaf_meta`` is the HostTier leaf table — pool leaf name to
    ``(global per-block shape, dtype)`` — and ``fingerprint`` the same
    pool/model config dict the session cache pins: a store directory
    is bound to one config, and a mismatched entry is refused loudly
    at fetch (never silently adopted into the wrong pool).
    """

    def __init__(
        self,
        root: str,
        leaf_meta: dict[str, tuple[tuple, torch.dtype]],
        *,
        block_len: int,
        fingerprint: dict | None = None,
    ):
        if not root:
            raise ValueError("prefix store needs a directory")
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        if META_MEMBER in leaf_meta:
            raise ValueError(
                f"pool leaf {META_MEMBER!r} shadows the store's meta "
                "member"
            )
        self.root = root
        self.leaf_meta = {
            name: (tuple(shape), dt) for name, (shape, dt) in leaf_meta.items()
        }
        self.block_len = block_len
        self.fingerprint = dict(fingerprint or {})
        os.makedirs(root, exist_ok=True)

    def block_nbytes(self) -> int:
        """Payload bytes one entry carries (every leaf, global shape)."""
        return sum(
            int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
            for shape, dt in self.leaf_meta.values()
        )

    def entry_path(self, path) -> str:
        return os.path.join(self.root, block_fingerprint(path) + ".npz")

    def publish(self, data: dict[str, torch.Tensor], path) -> int:
        """Commit one block's leaves under its path fingerprint;
        returns the payload bytes written.  tmp + ``os.replace``:
        concurrent publishers are last-commit-wins, readers are never
        torn.  Idempotent — republishing the same path overwrites with
        identical content (K/V at a path is a pure function of the
        path's tokens), so a retried publish is safe."""
        path = tuple(int(t) for t in path)
        if not path or len(path) % self.block_len:
            raise ValueError(
                f"store entry path must be a whole number of "
                f"{self.block_len}-token blocks, got {len(path)} tokens"
            )
        if set(data) != set(self.leaf_meta):
            raise ValueError(
                f"store block leaves {sorted(data)} != pool leaves "
                f"{sorted(self.leaf_meta)}"
            )
        payload: dict[str, np.ndarray] = {}
        for name, arr in data.items():
            shape, dt = self.leaf_meta[name]
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"store block leaf {name}: shape {tuple(arr.shape)}"
                    f" != declared {shape}"
                )
            payload[name] = leaf_to_numpy(arr, dt)
        meta = {
            "format": STORE_FORMAT,
            "fingerprint": self.fingerprint,
            "block_len": self.block_len,
            "path": list(path),
            "leaves": {
                name: {"shape": list(shape), "dtype": _dtype_name(dt)}
                for name, (shape, dt) in self.leaf_meta.items()
            },
            "digest": _payload_digest(payload),
        }
        final = self.entry_path(path)
        # pid + PROCESS-wide sequence: two handles on one directory in
        # one process (or threads sharing a handle) must not collide on
        # a tmp name, or the loser's os.replace rips the winner's
        # in-flight write out from under it
        tmp = f"{final}.{os.getpid()}.{next(_TMP_SEQ)}.tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(
                    f,
                    **{META_MEMBER: np.frombuffer(
                        json.dumps(meta).encode(), np.uint8
                    )},
                    **payload,
                )
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)  # a failed write never leaves litter
        return sum(a.nbytes for a in payload.values())

    def fetch(self, path) -> dict[str, torch.Tensor] | None:
        """The committed block at ``path``, or None on a miss.  A
        present entry is validated all the way down — store format,
        config fingerprint, block_len, the path itself, the leaf
        table, and the payload digest — and any mismatch raises
        ``ValueError`` loudly (the session cache's contract: a wrong
        block is refused, never adopted)."""
        path = tuple(int(t) for t in path)
        try:
            with np.load(self.entry_path(path)) as z:
                meta = json.loads(bytes(z[META_MEMBER]).decode())
                data = {
                    name: np.array(z[name], order="C")
                    for name in z.files
                    if name != META_MEMBER
                }
        except FileNotFoundError:
            return None
        except (zipfile.BadZipFile, KeyError, EOFError) as e:
            # disk rot: a committed entry that no longer parses is a
            # validation failure, not an I/O transient — surface it on
            # the same loud channel so the consumer recomputes fresh
            raise ValueError(
                f"prefix store entry for {path} is unreadable "
                f"({type(e).__name__}: {e}) under {self.root}"
            ) from e
        if meta.get("format") != STORE_FORMAT:
            raise ValueError(
                f"prefix store entry format {meta.get('format')} != "
                f"{STORE_FORMAT} under {self.root}"
            )
        if (
            self.fingerprint
            and meta.get("fingerprint")
            and meta["fingerprint"] != self.fingerprint
        ):
            diff = {
                k
                for k in set(self.fingerprint) | set(meta["fingerprint"])
                if self.fingerprint.get(k) != meta["fingerprint"].get(k)
            }
            raise ValueError(
                "prefix store entry was published under a different "
                f"pool/model config (mismatched: {sorted(diff)}) — "
                "point --prefix_store at a fresh directory or rerun "
                "with the original flags"
            )
        if meta.get("block_len") != self.block_len:
            raise ValueError(
                f"prefix store entry block_len {meta.get('block_len')} "
                f"!= pool block_len {self.block_len}"
            )
        if tuple(int(t) for t in meta.get("path", ())) != path:
            raise ValueError(
                "prefix store entry path does not match its "
                "fingerprint key (foreign or corrupt entry under "
                f"{self.root})"
            )
        try:
            saved = {
                name: (tuple(info["shape"]), _torch_dtype(info["dtype"]))
                for name, info in meta.get("leaves", {}).items()
            }
        except ValueError:
            saved = meta.get("leaves", {})
        if saved != self.leaf_meta:
            raise ValueError(
                f"prefix store entry leaf table {saved} != pool leaf "
                f"table {self.leaf_meta}"
            )
        if _payload_digest(data) != meta.get("digest"):
            raise ValueError(
                "prefix store entry payload digest mismatch (corrupt "
                f"entry under {self.root}) — refusing the block"
            )
        return {
            name: leaf_from_numpy(arr, self.leaf_meta[name][1])
            for name, arr in data.items()
        }

    def scan(self):
        """This config's committed entries, shallow-first (see module
        :func:`scan`)."""
        return scan(self.root, self.fingerprint)

    def __len__(self) -> int:
        try:
            return sum(
                1 for fn in os.listdir(self.root) if fn.endswith(".npz")
            )
        except FileNotFoundError:
            return 0
