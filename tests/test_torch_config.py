"""The port's three-tier configuration (``core/config.py``) against the
JAX package's, and the environment tier of the port's CLI.

Both packages' ``_coerce`` and ``config_from_tiers`` get the same strings,
environments and argv; their results must be equal (exact: no number is
computed).  Tests that read the process environment set and clear the
variables they use with ``monkeypatch``."""

import argparse
import dataclasses
import enum

import pytest

from tpu_patterns import cli as jcli
from tpu_patterns.core import config as jconfig
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.core import config as tconfig

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)


class Color(enum.Enum):
    RED = "red"
    DARK_BLUE = "dark-blue"


@dataclasses.dataclass
class Cfg:
    count: int = 4
    rate: float = 1.5
    name: str = "a"
    flag: bool = False
    on: bool = True
    limit: int | None = None
    color: Color = Color.RED
    shape: tuple[int, ...] = (1, 2)
    tags: list[str] = dataclasses.field(default_factory=lambda: ["x"])
    mode: str = dataclasses.field(default="p", metadata={"choices": ("p", "q")})


COERCE_CASES = [
    (int, "7"), (int, "-3"), (float, "2.5"), (float, "1e-3"), (str, "abc"),
    (bool, "1"), (bool, "true"), (bool, "YES"), (bool, "on"), (bool, "0"),
    (bool, "false"), (bool, "maybe"), (bool, ""),
    (int | None, ""), (int | None, "none"), (int | None, "None"),
    (int | None, "12"), (tuple[int, ...], "1,2,3"), (tuple[int, ...], "4,"),
    (list[str], "a,b"), (list[str], ""), (Color, "red"), (Color, "RED"),
    (Color, "dark-blue"), (Color, "DARK_BLUE"),
]


@pytest.mark.parametrize("ftype,raw", COERCE_CASES,
                         ids=[f"{t}-{r!r}" for t, r in COERCE_CASES])
def test_coerce_matches_reference(ftype, raw):
    assert tconfig._coerce(ftype, raw) == jconfig._coerce(ftype, raw)


@pytest.mark.parametrize("ftype,raw", [(int, "x"), (float, "one"),
                                       (Color, "green"), (int | None, "q")])
def test_coerce_refuses_as_reference(ftype, raw):
    with pytest.raises(ValueError):
        jconfig._coerce(ftype, raw)
    with pytest.raises(ValueError):
        tconfig._coerce(ftype, raw)


TIER_CASES = [
    ({}, []),
    ({"TPU_PATTERNS_COUNT": "9"}, []),
    ({"TPU_PATTERNS_COUNT": "9"}, ["--count", "11"]),
    ({"TPU_PATTERNS_FLAG": "yes", "TPU_PATTERNS_ON": "off"}, []),
    ({"TPU_PATTERNS_FLAG": "yes"}, ["--flag", "0"]),
    ({"TPU_PATTERNS_LIMIT": "none"}, ["--rate", "0.25"]),
    ({"TPU_PATTERNS_LIMIT": "5", "TPU_PATTERNS_COLOR": "dark-blue"}, []),
    ({}, ["--limit", "3", "--color", "RED", "--name", "zz"]),
    ({"TPU_PATTERNS_SHAPE": "3,4"}, ["--tags", "u,v,w"]),
    ({"TPU_PATTERNS_MODE": "q"}, []),
    ({"OTHER_COUNT": "1", "tpu_patterns_count": "2"}, ["--unknown", "1"]),
]


@pytest.mark.parametrize("env,argv", TIER_CASES)
def test_config_from_tiers_matches_reference(env, argv):
    """CLI > environment > default, field by field, in both packages."""
    got = tconfig.config_from_tiers(Cfg, argv, env=env)
    assert got == jconfig.config_from_tiers(Cfg, argv, env=env)
    assert tconfig.config_to_dict(got) == jconfig.config_to_dict(got)


def test_overrides_and_choices_match_reference():
    for mod in (tconfig, jconfig):
        assert mod.config_from_tiers(Cfg, ["--count", "2"], env={},
                                     count=5).count == 5
        with pytest.raises(SystemExit):
            mod.config_from_tiers(Cfg, ["--mode", "r"], env={})


def test_port_keywords_choices_and_coerce():
    """The port's two keywords: choices for a field without metadata and
    a replacement coercion, used by the flags and the environment."""
    p = argparse.ArgumentParser()
    tconfig.add_config_args(p, Cfg, env={"TPU_PATTERNS_ON": "nope"},
                            choices={"name": ("a", "b")},
                            coerce=lambda t, s: s.upper() if t is bool
                            else tconfig._coerce(t, s))
    ns = p.parse_args(["--name", "b", "--flag", "x"])
    assert (ns.name, ns.flag, ns.on) == ("b", "X", "NOPE")
    with pytest.raises(SystemExit):
        p.parse_args(["--name", "c"])
    with pytest.raises(ValueError, match="TPU_PATTERNS_COUNT='x'"):
        tconfig.add_config_args(argparse.ArgumentParser(), Cfg,
                                env={"TPU_PATTERNS_COUNT": "x"})


def _p2p_args(argv=()):
    return tcli.build_parser().parse_args(["p2p", *argv])


def test_cli_reads_the_environment_tier(monkeypatch):
    for var in ("REPS", "COUNT", "BIDIRECTIONAL", "DEVICE", "DCN",
                "MIN_SPEEDUP", "BLOCK_Q"):
        monkeypatch.delenv("TPU_PATTERNS_" + var, raising=False)
    base = _p2p_args()
    assert (base.reps, base.count, base.bidirectional) == (10, 1179648 * 40,
                                                           True)
    monkeypatch.setenv("TPU_PATTERNS_REPS", "3")
    monkeypatch.setenv("TPU_PATTERNS_BIDIRECTIONAL", "off")
    args = _p2p_args()
    assert (args.reps, args.bidirectional) == (3, False)
    assert _p2p_args(["--reps", "5"]).reps == 5  # CLI beats env
    monkeypatch.setenv("TPU_PATTERNS_DCN", "0")
    monkeypatch.setenv("TPU_PATTERNS_MIN_SPEEDUP", "0.5")
    monkeypatch.setenv("TPU_PATTERNS_BLOCK_Q", "64")
    parser = tcli.build_parser()
    assert parser.parse_args(["hier"]).dcn == 0
    assert parser.parse_args(["serve"]).min_speedup == 0.5
    assert parser.parse_args(["flagship"]).block_q == 64
    assert parser.parse_args(["longctx"]).block_q == 64
    assert parser.parse_args(["flagship", "--block_q", "32"]).block_q == 32
    # "none" is a value of flagship's optional block_q but not of
    # longctx's int one: the whole parser refuses it, naming the
    # variable, as the JAX package's does
    assert tcli._coerce_strict(int | None, "none") is None
    monkeypatch.setenv("TPU_PATTERNS_BLOCK_Q", "none")
    with pytest.raises(ValueError, match="TPU_PATTERNS_BLOCK_Q='none'"):
        tcli.build_parser()
    with pytest.raises(ValueError, match="invalid literal for int"):
        jcli.build_parser()
    monkeypatch.setenv("TPU_PATTERNS_DEVICE", "tpu")  # not a choice
    with pytest.raises(ValueError, match="TPU_PATTERNS_DEVICE='tpu'"):
        tcli.build_parser()


def test_cli_refuses_a_word_that_is_no_boolean(monkeypatch):
    """The CLI's coercion is stricter than the reference's: an unknown
    word raises, from a flag or the environment."""
    monkeypatch.delenv("TPU_PATTERNS_BIDIRECTIONAL", raising=False)
    assert jconfig._coerce(bool, "maybe") is False
    with pytest.raises(SystemExit):
        _p2p_args(["--bidirectional", "maybe"])
    assert _p2p_args(["--bidirectional", "no"]).bidirectional is False
    monkeypatch.setenv("TPU_PATTERNS_BIDIRECTIONAL", "maybe")
    with pytest.raises(ValueError, match="TPU_PATTERNS_BIDIRECTIONAL"):
        tcli.build_parser()
