"""The port's topology discovery, placement and bootstrap (``topo/``)
against the JAX package's.

The same fake devices (the reference test's ``FakeDevice``: coordinates,
cores, a process index) go through both packages' ``discover``; every
output (device fields, planes, neighbours, flat order, entries,
``describe``, the three placement orderings, ``select_devices`` and
``partition_devices``) must be equal, exact.  The reference runs its
Python path (its native loader is stubbed out, so no test worker builds
the reference's library); the port runs its C++ core (``auto``) and its
Python path, which must agree.  The rank placement of ``make_mesh`` is
held to the reference's ``_build_mesh`` rule up to one rank a device and
to its own rule past it, on fake topologies and on fake CUDA cards."""

import dataclasses
import importlib
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_patterns.topo import native as jnative
from tpu_patterns.topo import placement as jplace
from tpu_patterns.topo import topology as jtopo
from tpu_patterns_torch.comm import mesh as tmesh
from tpu_patterns_torch.topo import native as tnative
from tpu_patterns_torch.topo import placement as tplace
from tpu_patterns_torch.topo import topology as ttopo

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the modules, not the functions of the same name that ``topo`` exports
jboot = importlib.import_module("tpu_patterns.topo.bootstrap")
tboot = importlib.import_module("tpu_patterns_torch.topo.bootstrap")


@dataclasses.dataclass
class FakeDevice:
    """A device with torus coordinates (the reference test's)."""

    id: int
    coords: tuple
    core_on_chip: int
    process_index: int = 0
    platform: str = "faketpu"


@dataclasses.dataclass
class PlainDevice:
    """A device without coordinates: the coordinate-less path."""

    id: int
    process_index: int = 0
    platform: str = "gpu"


def grid(dims, cores=1):
    """Fake devices on a ``dims`` torus, ``cores`` a chip, coords-major."""
    devs = []
    for flat in range(math.prod(dims)):
        coords, rest = [], flat
        for d in reversed(dims):
            rest, c = divmod(rest, d)
            coords.insert(0, c)
        for core in range(cores):
            devs.append(FakeDevice(id=len(devs), coords=tuple(coords),
                                   core_on_chip=core))
    return devs


TOPOLOGIES = {
    "2x2x2cores": grid([2, 2], cores=2),  # the reference test's fake_slice
    "chain8": grid([8]),
    "chain3": grid([3]),
    "2x4": grid([2, 4]),
    "2x2x2": grid([2, 2, 2]),
    "4x1": grid([4, 1]),
    "single": grid([1]),
    "3d_cores": grid([2, 2, 2], cores=2),
    "plain4": [PlainDevice(i) for i in range(4)],
    "plain1": [PlainDevice(0)],
}


@pytest.fixture(autouse=True)
def _reference_python_path(monkeypatch):
    monkeypatch.setattr(jnative, "load", lambda: None)


def _both(name):
    devs = TOPOLOGIES[name]
    return jtopo.discover(devs), ttopo.discover(devs)


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_topology_matches_reference(name):
    ref, port = _both(name)
    assert [dataclasses.astuple(d) for d in port.devices] == [
        dataclasses.astuple(d) for d in ref.devices]
    assert (port.torus_shape, port.cores_per_chip, port.num_devices) == (
        ref.torus_shape, ref.cores_per_chip, ref.num_devices)
    want = ref.planes(impl="python")
    assert port.planes() == port.planes(impl="native") == want
    assert port.planes(impl="python") == want
    for d in ref.devices:
        want = ref.neighbors(d.index, impl="python")
        assert port.neighbors(d.index) == want
        assert port.neighbors(d.index, impl="python") == want
    assert port.flat() == ref.flat()
    assert [port.entry(k) for k in range(-3, 20)] == [
        ref.entry(k) for k in range(-3, 20)]
    assert port.describe() == ref.describe()


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_placement_matches_reference(name):
    ref, port = _both(name)
    for jm, tm in zip(jplace.PlacementMode, tplace.PlacementMode):
        assert jm.value == tm.value
        assert tplace.order_devices(port, tm) == jplace.order_devices(ref, jm)
        for num in (1, 3, port.num_devices, 2 * port.num_devices + 1):
            assert tplace.select_devices(num, port, tm) == \
                jplace.select_devices(num, ref, jm)
        for groups in (1, 2, 3, 16):
            for per in (None, 1, 2):
                try:
                    want = jplace.partition_devices(groups, ref, jm, per)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)[:20]):
                        tplace.partition_devices(groups, port, tm, per)
                    continue
                assert tplace.partition_devices(groups, port, tm,
                                                per) == want


@pytest.mark.parametrize("name", ["2x2x2cores", "3d_cores", "chain3",
                                  "plain4"])
def test_rank_devices_follow_the_reference_then_their_rules(name):
    """Up to one rank a device: MESH takes the first n of the mode's
    order and VISIBLE ``select_devices(n)``, as ``_build_mesh``; past
    it MESH deals blocks, rank r on ``order[r*g//n]``, and VISIBLE
    wraps modulo."""
    ref, port = _both(name)
    g = ref.num_devices
    for jm, tm in zip(jplace.PlacementMode, tplace.PlacementMode):
        order = jplace.order_devices(ref, jm)
        for n in range(1, 2 * g + 2):
            mesh = tplace.rank_devices(n, port, tm, tplace.Mechanism.MESH)
            vis = tplace.rank_devices(n, port, tm.value, "visible")
            assert vis == jplace.select_devices(n, ref, jm)
            if n <= g:
                assert mesh == order[:n] == vis
            else:
                assert mesh == [order[r * g // n] for r in range(n)]
                assert sorted(set(mesh)) == sorted(order)
                assert all(mesh.count(i) in (n // g, -(-n // g))
                           for i in order)
    with pytest.raises(ValueError, match="at least one rank"):
        tplace.rank_devices(0, port)


def test_make_mesh_over_fake_cards(monkeypatch):
    """Two CUDA cards (faked): more ranks than cards, each mechanism by
    its rule; ``default_mesh`` is ``make_mesh`` at compact/mesh; every
    card is coordinate-less, platform ``gpu``, one chain."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    topo = ttopo.discover()
    assert [(d.platform, d.coords, d.core_on_chip, d.synthetic_coords)
            for d in topo.devices] == [("gpu", (0,), 0, True),
                                       ("gpu", (1,), 0, True)]
    assert topo.planes() == [[0, 1]]

    def idx(mesh):
        return [d.index for d in mesh.devices]

    for mode in tplace.PlacementMode:
        assert idx(tplace.make_mesh(4, mode)) == [0, 0, 1, 1]
        assert idx(tplace.make_mesh(4, mode, "visible")) == [0, 1, 0, 1]
        assert idx(tplace.make_mesh(3, mode)) == [0, 0, 1]
        assert idx(tplace.make_mesh(1, mode, "visible")) == [0]
        assert idx(tplace.make_mesh(0, mode)) == [0, 1]
    for n in range(6):
        assert tmesh.default_mesh(n, "cuda") == tplace.make_mesh(n)
    cpu = tplace.make_mesh(3, "spread", "visible", "cpu")
    assert cpu.devices == (torch.device("cpu"),) * 3
    assert tmesh.default_mesh(0, "cpu") == tplace.make_mesh(0, device="cpu")


def test_discover_on_the_cpu_is_one_device():
    topo = ttopo.discover(device="cpu")
    assert topo.num_devices == 1 and topo.devices[0].platform == "cpu"
    assert topo.describe() == (
        "devices: 1 (cpu), torus 1, 1 core(s)/chip [synthetic coords]\n"
        "plane 0: [0]")


def test_native_core_maps_positions_and_refuses_bad_impl():
    devs = [ttopo.DeviceInfo(index=10 + p, id=p, process_index=0,
                             platform="fake", coords=(c,), core_on_chip=0,
                             synthetic_coords=False)
            for p, c in enumerate(range(4))]
    topo = ttopo.Topology(devices=devs)
    assert topo.planes(impl="native") == topo.planes(impl="python") == [
        [10, 11, 12, 13]]
    assert tnative.neighbors_native(devs, 0) == [11, 13]
    for bad in ("cuda", "jax"):
        with pytest.raises(ValueError, match="impl"):
            topo.planes(impl=bad)
        with pytest.raises(ValueError, match="impl"):
            topo.neighbors(0, impl=bad)


def test_auto_routes_to_the_native_core_and_a_failed_build_raises(
        monkeypatch, tmp_path):
    topo = ttopo.discover(TOPOLOGIES["2x2x2cores"])
    sentinel = [[99]]
    monkeypatch.setattr(tnative, "planes_native", lambda devs: sentinel)
    assert topo.planes() is sentinel
    assert topo.planes(impl="python") != sentinel
    # no quiet fallback: a core that cannot build raises, and again
    broken = tmp_path / "topo.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "TOPO", tnative.LazyLib(
        broken, tnative._configure, build_dir=tmp_path))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="native build of topo.cc"):
            topo.neighbors(0)


# -- bootstrap ---------------------------------------------------------------

_BOOT_VARS = (*tboot._COORD_VARS, *tboot._NPROC_VARS, *tboot._PID_VARS)


@pytest.fixture
def clean_env(monkeypatch):
    for v in _BOOT_VARS:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


def test_bootstrap_single_process_noop(clean_env):
    info = tboot.bootstrap(device="cpu")
    assert (info.process_id, info.num_processes, info.local_device_count,
            info.global_device_count) == (0, 1, 1, 1)
    assert info.is_coordinator
    assert dataclasses.asdict(info).keys() == {
        f.name for f in dataclasses.fields(jboot.ProcessInfo)}


@pytest.mark.parametrize("kw,env", [
    (dict(coordinator_address="localhost:1234"), {}),
    (dict(num_processes=4), {}),
    (dict(coordinator_address="localhost:1234", num_processes=4), {}),
    ({}, {"TPU_PATTERNS_COORDINATOR": "localhost:1"}),
    ({}, {"JAX_NUM_PROCESSES": "2", "PMI_RANK": "0"}),
    ({}, {"JAX_COORDINATOR_ADDRESS": "h:1", "TPU_PATTERNS_NUM_PROCESSES": "2"}),
])
def test_bootstrap_partial_config_rejected(clean_env, kw, env):
    """The reference's contract: a partial configuration raises, in both
    packages, never a quiet single-process run."""
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(ValueError, match="partial"):
        jboot.bootstrap(**kw)
    with pytest.raises(ValueError, match="partial"):
        tboot.bootstrap(**kw, device="cpu")


@pytest.mark.parametrize("var", ["PMI_RANK", "PALS_RANKID",
                                 "OMPI_COMM_WORLD_RANK"])
def test_bootstrap_rank_only_env_is_single_process(clean_env, var):
    clean_env.setenv(var, "0")
    clean_env.setenv("TPU_PATTERNS_NUM_PROCESSES", "1")
    assert tboot.bootstrap(device="cpu").num_processes == 1


def test_bootstrap_joins_two_cpu_processes(clean_env, tmp_path):
    """Two processes from the environment tier alone join one gloo group
    on localhost and report their identities."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("from tpu_patterns_torch.topo import bootstrap\n"
            "import torch.distributed as dist\n"
            "i = bootstrap(device='cpu')\n"
            "print(i.process_id, i.num_processes, i.global_device_count)\n"
            "dist.destroy_process_group()\n")
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in _BOOT_VARS}
        env.update(PYTHONPATH=str(ROOT), TPU_PATTERNS_NUM_PROCESSES="2",
                   TPU_PATTERNS_COORDINATOR=f"127.0.0.1:{port}",
                   PMI_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=60)
        finally:
            p.kill()
        assert p.returncode == 0, err
        outs.append(out.split())
    assert outs == [["0", "2", "2"], ["1", "2", "2"]]


# -- the topo CLI --------------------------------------------------------------

CLI_DEVICES = {
    **{k: TOPOLOGIES[k] for k in ("2x2x2cores", "3d_cores", "plain4",
                                  "plain1")},
    "two_processes": [dataclasses.replace(d, process_index=d.id // 4)
                      for d in grid([2, 4])],
    "irregular": [PlainDevice(i, process_index=p)
                  for i, p in enumerate((0, 0, 1))],
}


@pytest.mark.parametrize("name", CLI_DEVICES)
def test_topo_cli_prints_the_references_lines(name, monkeypatch, capsys):
    """``topo`` and ``topo N`` print, line for line, what the reference's
    ``_cmd_topo`` prints on the same devices."""
    import argparse

    import jax

    from tpu_patterns import cli as jcli
    from tpu_patterns_torch import cli as tcli

    devs = CLI_DEVICES[name]
    monkeypatch.setattr(jax, "devices", lambda *a: list(devs))
    monkeypatch.setattr(ttopo, "local_devices", lambda device=None: devs)
    outs = []
    for n in (None, 0, 1, 5, 17):
        jcli._cmd_topo(argparse.Namespace(n=n), None)
        outs.append(capsys.readouterr().out)
        argv = ["topo", "--device", "cpu"] + ([] if n is None else [str(n)])
        assert tcli.main(argv) == 0
        assert capsys.readouterr().out == outs[-1]
    assert ("irregular" in outs[0]) == (name == "irregular")
    assert all(len(o.splitlines()) == 1 for o in outs[1:])
