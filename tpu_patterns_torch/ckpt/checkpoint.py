"""Atomic checkpoints for trees (nested dicts) of torch tensors.

Counterpart of ``tpu_patterns/ckpt/checkpoint.py``, in its on-disk
format (version 1), so a checkpoint that either package writes is one
the other reads.  Layout of one committed checkpoint
(``<root>/step_<N>/``):

    manifest.json        leaf table: key -> shape/dtype/spec (the commit
                         marker, written last)
    proc0.npz            one entry per (leaf, shard): the shard's bytes
                         as a flat uint8 array (``"<leaf>.<shard>"``)
    shards_proc0.json    the shard table: leaf, entry name, and the
                         shard's [start, stop] a dimension

Leaves are keyed as ``jax.tree_util.keystr`` spells a dict path
(``['params']['wq']``) and numbered in sorted-key order; the dtype lives
in the manifest by name (``"bfloat16"`` included: the bytes never pass
through another type).  A tensor is one shard covering it whole, and its
``spec`` is one ``null`` a dimension.

Commit protocol (a checkpoint either exists complete or not at all):

    1. the shard file and shard table go into ``<root>/.tmp.step_<N>``;
       the ``ckpt.save`` fault site fires after them
    2. ``manifest.json`` LAST, every file and the tmp dir fsync'd, then
       the tmp dir is renamed to ``step_<N>`` (a committed step of that
       number is first renamed aside, never deleted before the commit)
       and ``LATEST`` rewritten by tmp + replace
    3. stale ``.tmp.*``/``.old.*`` dirs are ignored by restore and swept
       by the next save; ``keep`` prunes to the newest committed steps

A leaf is a tensor (one shard covering it whole) or a :class:`Sharded`
array, the per-rank blocks of a global array over a rank mesh: each
distinct block is written once (the rank whose ``replica`` is 0), with
its ``[start, stop]`` a dimension and the array's spec, as the JAX
package writes a ``NamedSharding``'s replica-0 shards.

Only one process writes.  A manifest with ``process_count > 1`` (the JAX
package's multi-process save) is read, each process's shards assembled
into the global array.  Restore fills a template tree: values from the
checkpoint, device from the template; a shape or dtype that differs from
the template's raises.  A :class:`Sharded` template is filled block by
block from the assembled global array, so a run saved on one mesh
resumes on another (the template's).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading

import numpy as np
import torch

from tpu_patterns_torch import faults

FORMAT_VERSION = 1

# same-size integer types in which shards are assembled before their
# bytes are reinterpreted as the manifest's dtype
_CARRIER = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


@dataclasses.dataclass
class Sharded:
    """A global array of ``shape`` held as per-rank blocks: ``shards[r]``
    is rank r's block, at ``index[r]`` (``[start, stop]`` a dimension);
    ``replica[r] == 0`` marks the one copy of a block that a save writes;
    ``spec`` names the mesh axis each dimension splits over (None:
    replicated), for the manifest."""

    shape: tuple
    spec: list
    shards: list
    index: list
    replica: list

    @classmethod
    def over(cls, mesh, shards: list, spec, shape=None) -> "Sharded":
        """The blocks ``shards`` of a global array split per ``spec``
        over ``mesh`` (a ``comm/mesh.py::NamedMesh``); ``shape`` defaults
        to the blocks' shape scaled by the split axes."""
        spec = list(spec) + [None] * (shards[0].dim() - len(spec))
        if shape is None:
            shape = [n * (mesh.dim(a) if a else 1)
                     for n, a in zip(shards[0].shape, spec)]
        return cls(tuple(shape), spec, list(shards),
                   [mesh.index(shape, spec, r) for r in range(mesh.size)],
                   [mesh.replica(spec, r) for r in range(mesh.size)])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def dim(self) -> int:
        return len(self.shape)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint dtype {name!r} is not a torch dtype")
    return dt


def _to_bytes_view(t: torch.Tensor) -> np.ndarray:
    """Flat uint8 view of a CPU tensor's bytes (bfloat16 included)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _keystr(path: tuple[str, ...]) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree, path=()) -> list[tuple[tuple[str, ...], object]]:
    """(path, leaf) pairs in sorted-key order, as the JAX package's tree
    flattening orders a dict."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], path + (k,))
        return out
    return [(path, tree)]


def _unflatten(like, leaves: dict):
    """``like``'s structure with each leaf replaced by ``leaves[path]``."""

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        return leaves[path]

    return build(like, ())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step}")


def _remove_step(root: str, step: int) -> None:
    """Delete a committed step: its commit marker first, so a crash
    mid-delete never leaves a torn dir that still looks committed."""
    path = _step_dir(root, step)
    try:
        os.unlink(os.path.join(path, "manifest.json"))
    except OSError:
        pass
    shutil.rmtree(path, ignore_errors=True)


def available_steps(root: str) -> list[int]:
    """Committed steps, ascending.  ``.tmp.*`` (crashed saves) excluded."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and os.path.isfile(
            os.path.join(root, name, "manifest.json")
        ):
            try:
                steps.append(int(name[len("step_"):]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(root: str) -> int | None:
    """Newest committed step, by scan (``LATEST`` is for humans and
    tools: a crash between the rename and the pointer rewrite leaves a
    committed step the pointer missed)."""
    steps = available_steps(root)
    return max(steps) if steps else None


def _prepare_tmp(root: str, step: int) -> str:
    """A fresh tmp dir for one save attempt."""
    tmp = os.path.join(root, f".tmp.step_{step}")
    os.makedirs(root, exist_ok=True)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    return tmp


def _snapshot(tree, copy: bool = False):
    """The tree's bytes on the host, with the shard table and manifest
    entries describing them.  Device tensors are copied to the host
    here (synchronously); ``copy=True`` (the async saver) also copies
    host tensors, so a thread can write them while training goes on."""
    shard_table, arrays, manifest_leaves = [], {}, []
    for leaf_id, (path, leaf) in enumerate(_flatten(tree)):
        if isinstance(leaf, Sharded):
            blocks = [(s, idx) for s, idx, rep in zip(
                leaf.shards, leaf.index, leaf.replica) if rep == 0]
            # a PartitionSpec's trailing Nones are dropped, as JAX
            # normalises it
            spec = list(leaf.spec)
            while spec and spec[-1] is None:
                spec.pop()
        elif isinstance(leaf, torch.Tensor):
            blocks = [(leaf, [[None, None]] * leaf.dim())]
            spec = [None] * leaf.dim()
        else:
            raise TypeError(
                f"checkpoint leaf {_keystr(path)} is {type(leaf).__name__}; "
                "only torch.Tensor and Sharded leaves are checkpointable"
            )
        for shard_id, (block, index) in enumerate(blocks):
            host = block.detach()
            if host.device.type != "cpu":
                host = host.to("cpu")
            elif copy:
                host = host.clone()
            name = f"{leaf_id}.{shard_id}"
            arrays[name] = _to_bytes_view(host)
            shard_table.append({"leaf": leaf_id, "name": name,
                                "index": index})
        manifest_leaves.append({
            "key": _keystr(path),
            "leaf": leaf_id,
            "shape": list(leaf.shape),
            "dtype": _dtype_name(leaf.dtype),
            "spec": spec,
        })
    return shard_table, arrays, manifest_leaves


_RESERVED_PREFIXES = ("manifest", "proc", "shards_proc")


def _check_extras(extras) -> dict[str, bytes]:
    out: dict[str, bytes] = {}
    for name, data in (extras or {}).items():
        if (
            os.path.basename(name) != name
            or name.startswith(_RESERVED_PREFIXES)
        ):
            raise ValueError(
                f"extra {name!r}: must be a bare filename not starting "
                f"with {_RESERVED_PREFIXES}"
            )
        out[name] = data.encode() if isinstance(data, str) else bytes(data)
    return out


def _save_with_retry(root: str, step: int, snapshot, keep, extras) -> str:
    def attempt() -> str:
        _prepare_tmp(root, step)  # each attempt starts clean
        return _write_and_commit(root, step, snapshot, keep, extras)

    return faults.call_with_retry(
        attempt,
        policy=faults.ckpt_retry_policy(),
        site="ckpt.save",
        retry_on=(OSError,),
    )


def save(root: str, step: int, tree, *, keep: int | None = None,
         extras=None) -> str:
    """Write one atomic checkpoint of ``tree`` at ``step``; returns the
    committed directory.

    Every leaf must be a tensor.  ``extras`` maps bare filenames to
    str/bytes payloads written beside the shards before the manifest,
    so they ride the same commit (read them with :func:`read_extra`).
    ``keep=k`` prunes all but the newest k committed steps after the
    commit.  Transient I/O errors retry under the ckpt
    :class:`~tpu_patterns_torch.faults.RetryPolicy`, each attempt from a
    fresh tmp dir with the same host snapshot.
    """
    extras = _check_extras(extras)
    return _save_with_retry(root, step, _snapshot(tree), keep, extras)


def _write_and_commit(root, step, snapshot, keep, extras=None) -> str:
    """The file-writing and atomic-commit half of :func:`save`, on a host
    snapshot only: callable from the async saver's thread."""
    shard_table, arrays, manifest_leaves = snapshot
    tmp = os.path.join(root, f".tmp.step_{step}")

    with open(os.path.join(tmp, "proc0.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "shards_proc0.json"), "w") as f:
        json.dump(shard_table, f)
        f.flush()
        os.fsync(f.fileno())

    # fault site: MID-save -- shards on disk, the commit marker not yet
    # written.  A crash here leaves the torn ``.tmp.step_N`` that restore
    # ignores and the next save sweeps; an ``error`` is a transient I/O
    # failure the save's retry policy absorbs.
    faults.inject("ckpt.save", step=step, proc=0)
    for name, data in (extras or {}).items():
        with open(os.path.join(tmp, name), "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
    manifest = {
        "format": FORMAT_VERSION,
        "step": step,
        "process_count": 1,
        "leaves": manifest_leaves,
    }
    # manifest LAST: its presence is the commit marker for a scan
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # the dir entries must be durable before the rename makes them
    # reachable
    _fsync_dir(tmp)
    final = _step_dir(root, step)
    aside = os.path.join(root, f".old.step_{step}")
    # overwriting a committed step renames the old one aside first: a
    # crash can lose only this step, never leave a torn directory
    shutil.rmtree(aside, ignore_errors=True)
    if os.path.isdir(final):
        os.rename(final, aside)
    os.replace(tmp, final)
    shutil.rmtree(aside, ignore_errors=True)
    _fsync_dir(root)
    ptr_tmp = os.path.join(root, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptr_tmp, os.path.join(root, "LATEST"))
    # sweep crashed saves' tmp/aside dirs and out-of-retention steps
    for name in os.listdir(root):
        if name.startswith((".tmp.step_", ".old.step_")):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    if keep is not None and keep > 0:
        for old in available_steps(root)[:-keep]:
            _remove_step(root, old)
    return final


class AsyncSaver:
    """Background checkpoint writer: ``save()`` copies the tree to the
    host SYNCHRONOUSLY (the tensors are free to change as soon as it
    returns) and commits the files from a worker thread with the same
    protocol.  At most one save is in flight; the next ``save()`` (and
    ``wait()``) joins the previous one and re-raises its error."""

    def __init__(self):
        self._thread = None
        self._result: dict = {}

    def save(self, root: str, step: int, tree, *, keep=None) -> None:
        self.wait()
        snapshot = _snapshot(tree, copy=True)
        result: dict = {}

        def work():
            try:
                _save_with_retry(root, step, snapshot, keep, None)
            except BaseException as e:  # surfaced by the next wait()
                result["error"] = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._result = result
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight save (if any) and re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            err = self._result.pop("error", None)
            if err is not None:
                raise err

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()


class _ShardReader:
    """Every process's shard table and npz handle, opened once for a
    whole restore."""

    def __init__(self, step_path: str, process_count: int):
        self.step_path = step_path
        self.by_leaf: dict[int, list[tuple[int, dict]]] = {}
        self.z = {}
        for p in range(process_count):
            with open(os.path.join(step_path, f"shards_proc{p}.json")) as f:
                for e in json.load(f):
                    self.by_leaf.setdefault(e["leaf"], []).append((p, e))
            self.z[p] = np.load(os.path.join(step_path, f"proc{p}.npz"))

    def close(self) -> None:
        for z in self.z.values():
            z.close()

    def load_global(self, manifest: dict, leaf_id: int) -> torch.Tensor:
        """One leaf's global array, assembled from every process's
        shards, as a CPU tensor of the manifest's dtype."""
        info = manifest["leaves"][leaf_id]
        dtype = _torch_dtype(info["dtype"])
        carrier = _CARRIER[torch.empty((), dtype=dtype).element_size()]
        out = np.empty(tuple(info["shape"]), dtype=carrier)
        filled = np.zeros(out.shape, dtype=bool) if out.size else None
        for p, e in self.by_leaf.get(leaf_id, ()):
            idx = tuple(slice(a, b) for a, b in e["index"])
            out[idx] = self.z[p][e["name"]].view(carrier).reshape(
                out[idx].shape
            )
            if filled is not None:
                filled[idx] = True
        if filled is not None and not filled.all():
            raise ValueError(
                f"checkpoint {self.step_path} is missing shards for leaf "
                f"{info['key']}: only {int(filled.sum())}/{filled.size} "
                "elements present (partial or corrupted save?)"
            )
        return torch.from_numpy(out).view(dtype)


def restore(root: str, like, *, step: int | None = None):
    """Fill the ``like`` template from the checkpoint at ``step``
    (default: the latest committed one).

    ``like``'s leaves are tensors that give each leaf's shape, dtype and
    device, or :class:`Sharded` arrays whose blocks give each rank's
    device and whose ``index`` says which block each rank gets (the
    mesh to restore onto); leaves are matched to saved entries by key,
    and every
    template leaf must be in the checkpoint with the template's shape
    and dtype (a mismatch raises; nothing is cast).  Transient I/O
    errors retry under the ckpt policy; a missing checkpoint raises
    FileNotFoundError at once.
    """
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    step_path = _step_dir(root, step)
    if not os.path.isfile(os.path.join(step_path, "manifest.json")):
        raise FileNotFoundError(
            f"no committed checkpoint at step {step} under {root}"
        )

    def attempt():
        faults.inject("ckpt.restore", step=step)
        with open(os.path.join(step_path, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {info["key"]: info for info in manifest["leaves"]}
        reader = _ShardReader(step_path, manifest["process_count"])
        try:
            out = {}
            for path, leaf in _flatten(like):
                key = _keystr(path)
                info = by_key.get(key)
                if info is None:
                    raise KeyError(
                        f"template leaf {key} not in checkpoint step {step} "
                        f"(has: {sorted(by_key)[:8]}...)"
                    )
                if tuple(info["shape"]) != tuple(leaf.shape):
                    raise ValueError(
                        f"{key}: checkpoint shape {tuple(info['shape'])} != "
                        f"template shape {tuple(leaf.shape)}"
                    )
                if info["dtype"] != _dtype_name(leaf.dtype):
                    raise ValueError(
                        f"{key}: checkpoint dtype {info['dtype']} != "
                        f"template dtype {_dtype_name(leaf.dtype)}"
                    )
                host = reader.load_global(manifest, info["leaf"])
                if isinstance(leaf, Sharded):
                    out[path] = dataclasses.replace(leaf, shards=[
                        host[tuple(slice(a, b) for a, b in idx)].to(
                            t.device).contiguous()
                        for t, idx in zip(leaf.shards, leaf.index)])
                else:
                    out[path] = host.to(leaf.device)
        finally:
            reader.close()
        return _unflatten(like, out)

    return faults.call_with_retry(
        attempt,
        policy=faults.ckpt_retry_policy(),
        site="ckpt.restore",
        retry_on=(OSError,),
    )


def read_extra(root: str, name: str, *, step: int | None = None) -> bytes:
    """A sidecar file written via ``save(..., extras=...)`` from the
    committed step (default: latest)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    with open(os.path.join(_step_dir(root, step), name), "rb") as f:
        return f.read()


def describe(root: str) -> dict:
    """Operator's view of a checkpoint directory: committed steps, and a
    leaf table (key, shape, dtype, spec) and on-disk bytes a step.
    Read-only and manifest-driven: it never touches shard data."""
    out = {"root": os.path.abspath(root), "steps": []}
    for step in available_steps(root):
        path = _step_dir(root, step)
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            names = os.listdir(path)
        except OSError:
            continue  # pruned or re-committed between the scan and here
        n_bytes = 0
        for name in names:
            try:
                n_bytes += os.path.getsize(os.path.join(path, name))
            except OSError:
                pass
        out["steps"].append({
            "step": step,
            "bytes": n_bytes,
            "process_count": manifest.get("process_count", 1),
            "leaves": [
                {
                    "key": info["key"],
                    "shape": info["shape"],
                    "dtype": info["dtype"],
                    "spec": info.get("spec", []),
                }
                for info in manifest["leaves"]
            ],
        })
    return out
