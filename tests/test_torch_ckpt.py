"""The port's checkpoints against the JAX package's format and protocol.

Round trips are bitwise (float32, bfloat16, the int32 step); a torn
``.tmp.step_N`` is invisible and swept; retention prunes; the async
saver commits what a sync save commits and surfaces its thread's error
on ``wait``.  Across packages, in both directions: the port restores a
checkpoint the reference wrote bit for bit, the reference's
``describe`` and ``restore`` read one the port wrote, and both ``ckpt``
commands print the same lines for the same directory."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_patterns import ckpt as jc
from tpu_patterns import cli as jcli
from tpu_patterns import faults as jf
from tpu_patterns_torch import ckpt as tc
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch import faults as tf
from tpu_patterns_torch.convert import tensor_from_numpy

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in (jf, tf):
        pkg.configure("")
    yield
    for pkg in (jf, tf):
        pkg.configure(None)


def _arrays(seed=0):
    """A train-loop-shaped tree as numpy: f32 and bf16 params, an int32
    step scalar, a nested dict."""
    rs = np.random.RandomState(seed)
    bf16 = jnp.asarray(rs.randn(4, 6).astype(np.float32)).astype(
        jnp.bfloat16)
    return {
        "params": {
            "wqkv": rs.randn(3, 8, 2, 4).astype(np.float32),
            "w1": rs.randn(8, 16).astype(np.float32),
            "h": np.asarray(bf16),
        },
        "step": np.asarray(7, np.int32),
    }


def _torch_tree(a):
    if isinstance(a, dict):
        return {k: _torch_tree(v) for k, v in a.items()}
    return tensor_from_numpy(a)


def _jax_tree(a):
    if isinstance(a, dict):
        return {k: _jax_tree(v) for k, v in a.items()}
    return jnp.asarray(a)


def _bytes_of(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(t)).tobytes()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    return {path: tree}


def _assert_same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert set(la) == set(lb)
    for k in la:
        assert tuple(la[k].shape) == tuple(lb[k].shape), k
        assert str(la[k].dtype).removeprefix("torch.") == str(
            lb[k].dtype).removeprefix("torch."), k
        assert _bytes_of(la[k]) == _bytes_of(lb[k]), k


def _empty_like(tree):
    return {k: _empty_like(v) if isinstance(v, dict) else torch.empty_like(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.float16, torch.int8])
def test_round_trip_bitwise(tmp_path, dtype):
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(1)) * 50
    tree = {"x": x.to(dtype), "step": torch.tensor(9, dtype=torch.int32),
            "s": torch.tensor(2.5).to(dtype)}
    tc.save(str(tmp_path), 9, tree)
    back = tc.restore(str(tmp_path), _empty_like(tree))
    _assert_same_bits(tree, back)
    assert int(back["step"]) == 9


def test_round_trip_train_tree(tmp_path):
    tree = _torch_tree(_arrays())
    path = tc.save(str(tmp_path), 3, tree)
    assert path == os.path.join(str(tmp_path), "step_3")
    assert sorted(os.listdir(path)) == ["manifest.json", "proc0.npz",
                                        "shards_proc0.json"]
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["format"] == 1 and man["process_count"] == 1
    assert [e["key"] for e in man["leaves"]] == [
        "['params']['h']", "['params']['w1']", "['params']['wqkv']",
        "['step']"]
    assert [e["dtype"] for e in man["leaves"]] == [
        "bfloat16", "float32", "float32", "int32"]
    assert man["leaves"][2]["spec"] == [None] * 4
    assert man["leaves"][3]["spec"] == []
    _assert_same_bits(tree, tc.restore(str(tmp_path), _empty_like(tree)))


def test_restore_refuses_mismatched_template(tmp_path):
    tree = _torch_tree(_arrays())
    tc.save(str(tmp_path), 1, tree)
    bad_shape = _empty_like(tree)
    bad_shape["params"]["w1"] = torch.empty(8, 15)
    with pytest.raises(ValueError, match="shape"):
        tc.restore(str(tmp_path), bad_shape)
    bad_dtype = _empty_like(tree)
    bad_dtype["params"]["h"] = torch.empty(4, 6, dtype=torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        tc.restore(str(tmp_path), bad_dtype)
    extra = _empty_like(tree)
    extra["params"]["w9"] = torch.empty(1)
    with pytest.raises(KeyError, match="w9"):
        tc.restore(str(tmp_path), extra)
    with pytest.raises(FileNotFoundError):
        tc.restore(str(tmp_path), tree, step=5)
    with pytest.raises(FileNotFoundError):
        tc.restore(str(tmp_path / "none"), tree)


def test_restore_subset_template_by_key(tmp_path):
    tree = _torch_tree(_arrays())
    tc.save(str(tmp_path), 1, tree)
    back = tc.restore(str(tmp_path), {"step": torch.zeros((),
                                                          dtype=torch.int32)})
    assert int(back["step"]) == 7


def test_non_tensor_leaf_rejected(tmp_path):
    with pytest.raises(TypeError, match="torch.Tensor"):
        tc.save(str(tmp_path), 1, {"step": 3})


def test_crashed_save_is_invisible_and_swept(tmp_path):
    root = str(tmp_path)
    tree = _torch_tree(_arrays())
    tc.save(root, 1, tree)
    torn = tmp_path / ".tmp.step_2"
    torn.mkdir()
    (torn / "proc0.npz").write_bytes(b"torn")
    assert tc.available_steps(root) == [1]
    assert tc.latest_step(root) == 1
    _assert_same_bits(tree, tc.restore(root, _empty_like(tree)))
    tc.save(root, 3, tree)
    assert not torn.exists()
    assert tc.available_steps(root) == [1, 3]


def test_manifest_is_the_commit_marker(tmp_path):
    root = str(tmp_path)
    tree = _torch_tree(_arrays())
    tc.save(root, 1, tree)
    tc.save(root, 2, tree)
    os.unlink(os.path.join(root, "step_2", "manifest.json"))
    assert tc.available_steps(root) == [1]
    assert tc.latest_step(root) == 1


def test_kill_mid_save_leaves_torn_tmp_next_save_sweeps(tmp_path):
    root = str(tmp_path / "ck")
    prog = textwrap.dedent("""
        import sys, torch
        from tpu_patterns_torch import ckpt
        ckpt.save(sys.argv[1], 1, {"w": torch.arange(32.0)})
        """)
    env = dict(os.environ, PYTHONPATH=ROOT,
               TPU_PATTERNS_FAULTS="ckpt.save:kill")
    proc = subprocess.run([sys.executable, "-c", prog, root], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == -9, proc.stderr
    torn = os.path.join(root, ".tmp.step_1")
    assert os.path.isdir(torn) and os.listdir(torn)  # shards landed
    assert "manifest.json" not in os.listdir(torn)
    assert tc.latest_step(root) is None
    tree = {"w": torch.arange(32.0)}
    tc.save(root, 2, tree)
    assert not os.path.exists(torn)
    assert tc.available_steps(root) == [2]
    _assert_same_bits(tree, tc.restore(root, _empty_like(tree)))


def test_save_retries_transient_error_to_clean_commit(tmp_path):
    tf.configure("ckpt.save:error:count=1")
    root = str(tmp_path)
    tree = _torch_tree(_arrays())
    tc.save(root, 1, tree)
    assert tc.available_steps(root) == [1]
    assert not [n for n in os.listdir(root) if n.startswith(".tmp.")]
    _assert_same_bits(tree, tc.restore(root, _empty_like(tree)))


def test_deterministic_save_error_quarantines_and_commits_nothing(tmp_path):
    tf.configure("ckpt.save:error:count=9")
    with pytest.raises(tf.Quarantined):
        tc.save(str(tmp_path), 1, _torch_tree(_arrays()))
    assert tc.available_steps(str(tmp_path)) == []


def test_restore_retries_transient_error(tmp_path):
    tree = _torch_tree(_arrays())
    tc.save(str(tmp_path), 1, tree)
    tf.configure("ckpt.restore:error:count=1")
    _assert_same_bits(tree, tc.restore(str(tmp_path), _empty_like(tree)))


def test_same_step_overwrite_and_latest_pointer(tmp_path):
    root = str(tmp_path)
    a = _torch_tree(_arrays(0))
    b = _torch_tree(_arrays(1))
    tc.save(root, 4, a)
    tc.save(root, 4, b)
    assert tc.available_steps(root) == [4]
    assert (tmp_path / "LATEST").read_text() == "4"
    assert not [n for n in os.listdir(root) if n.startswith(".old.")]
    _assert_same_bits(b, tc.restore(root, _empty_like(b)))


@pytest.mark.parametrize("keep,want", [(1, [5]), (2, [4, 5]), (None,
                                                                [1, 2, 3, 4, 5])])
def test_retention_prunes_oldest(tmp_path, keep, want):
    tree = _torch_tree(_arrays())
    for s in range(1, 6):
        tc.save(str(tmp_path), s, tree, keep=keep)
    assert tc.available_steps(str(tmp_path)) == want


def test_extras_ride_the_commit(tmp_path):
    tree = _torch_tree(_arrays())
    tc.save(str(tmp_path), 1, tree, extras={"sched.json": '{"a": 1}'})
    assert tc.read_extra(str(tmp_path), "sched.json") == b'{"a": 1}'
    with pytest.raises(ValueError, match="bare filename"):
        tc.save(str(tmp_path), 2, tree, extras={"manifest.x": b""})


def test_async_commit_matches_sync(tmp_path):
    tree = _torch_tree(_arrays())
    tc.save(str(tmp_path / "s"), 2, tree)
    with tc.AsyncSaver() as saver:
        saver.save(str(tmp_path / "a"), 2, tree)
    for name in ("manifest.json", "shards_proc0.json"):
        assert (tmp_path / "s" / "step_2" / name).read_bytes() == (
            tmp_path / "a" / "step_2" / name).read_bytes()
    _assert_same_bits(tc.restore(str(tmp_path / "s"), _empty_like(tree)),
                      tc.restore(str(tmp_path / "a"), _empty_like(tree)))


def test_async_snapshot_detaches_from_later_mutation(tmp_path):
    tree = {"w": torch.arange(64.0)}
    saver = tc.AsyncSaver()
    saver.save(str(tmp_path), 1, tree)
    tree["w"].add_(1000.0)  # the caller goes on at once
    saver.wait()
    back = tc.restore(str(tmp_path), _empty_like(tree))
    assert torch.equal(back["w"], torch.arange(64.0))


def test_async_thread_error_surfaces_on_wait(tmp_path):
    tf.configure("ckpt.save:error:count=9")
    saver = tc.AsyncSaver()
    saver.save(str(tmp_path), 1, {"w": torch.ones(3)})
    with pytest.raises(tf.Quarantined):
        saver.wait()
    saver.wait()  # reported once
    assert tc.available_steps(str(tmp_path)) == []


def test_async_sequential_saves_serialize(tmp_path):
    tree = {"w": torch.ones(3)}
    with tc.AsyncSaver() as saver:
        for s in (1, 2, 3):
            saver.save(str(tmp_path), s, tree, keep=2)
    assert tc.available_steps(str(tmp_path)) == [2, 3]


# -- across packages ---------------------------------------------------------


def test_port_restores_reference_checkpoint_bitwise(tmp_path):
    arrays = _arrays(3)
    jc.save(str(tmp_path), 5, _jax_tree(arrays))
    back = tc.restore(str(tmp_path), _torch_tree(_arrays(9)))
    _assert_same_bits(back, _torch_tree(arrays))
    assert tc.available_steps(str(tmp_path)) == [5]


def test_reference_reads_port_checkpoint(tmp_path):
    arrays = _arrays(4)
    tc.save(str(tmp_path), 6, _torch_tree(arrays))
    info = jc.describe(str(tmp_path))
    assert info == tc.describe(str(tmp_path))
    assert [s["step"] for s in info["steps"]] == [6]
    back = jc.restore(str(tmp_path), _jax_tree(_arrays(0)))
    _assert_same_bits(_leaves_np(back), _leaves_np(_jax_tree(arrays)))


def _leaves_np(tree):
    return {k: _leaves_np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def test_reference_restores_into_a_sharded_template(tmp_path, devices):
    """The port's whole-tensor shard reads back onto a 2-device mesh."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    arrays = _arrays(5)
    tc.save(str(tmp_path), 1, _torch_tree(arrays))
    mesh = Mesh(np.array(devices[:2]), ("x",))
    like = jax.tree.map(lambda a: jax.device_put(
        jnp.zeros_like(a), NamedSharding(mesh, P())), _jax_tree(arrays))
    like["params"]["w1"] = jax.device_put(
        jnp.zeros((8, 16), jnp.float32), NamedSharding(mesh, P("x")))
    back = jc.restore(str(tmp_path), like)
    np.testing.assert_array_equal(np.asarray(back["params"]["w1"]),
                                  arrays["params"]["w1"])


def test_port_reads_a_multi_process_manifest(tmp_path):
    """A manifest with process_count 2 (the JAX package's multi-process
    save: each process its shards, in its own files) assembles each
    leaf from both; a missing shard raises."""
    tree = _torch_tree(_arrays(6))
    step_dir = tmp_path / "step_1"
    tc.save(str(tmp_path), 1, tree)
    man = json.loads((step_dir / "manifest.json").read_text())
    with np.load(step_dir / "proc0.npz") as z:
        arrays = {k: z[k] for k in z.files}
    tables = {0: [], 1: []}
    parts = {0: {}, 1: {}}
    for leaf in man["leaves"]:
        name = f"{leaf['leaf']}.0"
        shape = leaf["shape"]
        if len(shape) and shape[0] % 2 == 0:
            # split the leading axis between the two processes
            half = shape[0] // 2
            cut = half * (len(arrays[name]) // shape[0])
            for p, (lo, hi, raw) in enumerate((
                    (0, half, arrays[name][:cut]),
                    (half, shape[0], arrays[name][cut:]))):
                idx = [[lo, hi]] + [[None, None]] * (len(shape) - 1)
                parts[p][f"{leaf['leaf']}.{p}"] = raw
                tables[p].append({"leaf": leaf["leaf"],
                                  "name": f"{leaf['leaf']}.{p}",
                                  "index": idx})
        else:
            parts[0][name] = arrays[name]
            tables[0].append({"leaf": leaf["leaf"], "name": name,
                              "index": [[None, None]] * len(shape)})
    for p in (0, 1):
        np.savez(step_dir / f"proc{p}.npz", **parts[p])
        (step_dir / f"shards_proc{p}.json").write_text(json.dumps(tables[p]))
    man["process_count"] = 2
    (step_dir / "manifest.json").write_text(json.dumps(man))
    _assert_same_bits(tree, tc.restore(str(tmp_path), _empty_like(tree)))
    # drop process 1's shards: the assembled leaves are incomplete
    (step_dir / "shards_proc1.json").write_text("[]")
    with pytest.raises(ValueError, match="missing shards"):
        tc.restore(str(tmp_path), _empty_like(tree))


def _cli_lines(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, [ln for ln in out.splitlines() if not ln.startswith("#")]


@pytest.mark.parametrize("writer", ["port", "reference", "empty"])
@pytest.mark.parametrize("leaves", [False, True])
def test_ckpt_cli_prints_the_reference_lines(tmp_path, capsys, writer,
                                             leaves):
    root = str(tmp_path / "ck")
    arrays = _arrays(7)
    for s in (2, 4):
        if writer == "port":
            tc.save(root, s, _torch_tree(arrays), keep=2)
        elif writer == "reference":
            jc.save(root, s, _jax_tree(arrays), keep=2)
    argv = ["ckpt", root] + (["--leaves"] if leaves else [])
    got = _cli_lines(tcli.main, argv, capsys)
    want = _cli_lines(jcli.main, argv, capsys)
    assert got == want
    assert got[0] == 0
    if writer != "empty":
        assert got[1][-1] == "latest: step_4"
        assert len(got[1]) == (2 + 2 * 4 + 1 if leaves else 3)


def test_copied_checkpoint_restores_identically(tmp_path):
    tree = _torch_tree(_arrays())
    tc.save(str(tmp_path / "a"), 1, tree)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    _assert_same_bits(tc.restore(str(tmp_path / "b"), _empty_like(tree)),
                      tree)
