"""The readers of ``report`` (``tpu_patterns_torch/core/results.py``)
against the JAX package's (``tpu_patterns/core/results.py``).

One mixed log (``export`` context lines, ``##`` markers, JSON Records,
noise) gives equal Records in both packages; the first-pass supersede,
the stale-grad refusal and the integrity flags agree; the tables hold
the same rows (the port draws them with ``obs/table.py``, the reference
with ``tabulate``); and ``python -m tpu_patterns_torch report`` prints
the reference's table rows and refuses the same stale records.
"""

import contextlib
import dataclasses
import io

import pytest

from tpu_patterns import cli as jcli
from tpu_patterns.core import results as jr
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.core import results as tr

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)


def _json(res, **kw):
    kw.setdefault("timestamp", 1.9e9)
    kw["verdict"] = res.Verdict(kw.get("verdict", "SUCCESS"))
    return res.Record(**kw).to_json()


def _log(res) -> list[str]:
    """A cell log and its JSONL joined, with the lines parse.py reads
    and some it must skip."""
    return [
        "export TPU_PATTERNS_SWEEP_CONFIG=measured.flash\n",
        "+ export XLA_FLAGS='--x=1'\n",
        "# progress line\n",
        "## xla:concurrent | C C | FAILURE\n",
        "## local_put | count=65536 | SUCCESS\n",  # shadowed by its JSON
        "bandwidth: 12.3 GB/s\n",
        "{not json\n",
        "## flash | L4096 | WARNING\n",
        "export TPU_PATTERNS_SWEEP_TIER=first_pass\n",
        "## flash | L8192 | SKIPPED\n",
        _json(res, pattern="onesided", mode="local_put",
              commands="count=65536",
              metrics={"bandwidth_GBps": 1466.5, "hbm_plausible": 0.0,
                       "timing_converged": 0.0},
              env={"TPU_PATTERNS_SWEEP_CONFIG": "measured.onesided_hbm"})
        + "\n",
        _json(res, pattern="longctx", mode="flash_grad", commands="x",
              metrics={"tflops": 189.7}, timestamp=1.0) + "\n",
        _json(res, pattern="longctx", mode="flash_grad", commands="y",
              metrics={"tflops": 10.0}, timestamp=1.0, superseded=True)
        + "\n",
    ]


def _strip(rec) -> dict:
    d = dataclasses.asdict(rec)
    d["verdict"] = rec.verdict.value
    d.pop("timestamp")  # marker Records are stamped when parsed
    return d


def test_parse_log_gives_the_references_records():
    got = tr.parse_log(_log(tr))
    want = jr.parse_log(_log(jr))
    assert [_strip(r) for r in got] == [_strip(r) for r in want]
    assert [r.mode for r in got] == [
        "xla:concurrent", "flash", "flash", "local_put", "flash_grad",
        "flash_grad"]
    assert got[2].env == {"TPU_PATTERNS_SWEEP_CONFIG": "measured.flash",
                          "XLA_FLAGS": "--x=1",
                          "TPU_PATTERNS_SWEEP_TIER": "first_pass"}


def test_stale_grad_and_integrity_flags_agree():
    got = tr.parse_log(_log(tr))
    want = jr.parse_log(_log(jr))
    assert tr.GRAD_ACCOUNTING_FIX_TS == jr.GRAD_ACCOUNTING_FIX_TS
    assert [r.commands for r in tr.stale_grad_records(got)] == [
        r.commands for r in jr.stale_grad_records(want)] == ["x"]
    assert [tr.integrity_flags(r) for r in got] == [
        jr.integrity_flags(r) for r in want]
    assert tr.integrity_flags(got[3]) == ["NOISE-BOUND", "NOT-HBM"]


@pytest.mark.parametrize("pairs,kept", [
    # a refined record shadows its first-pass twin of the same cell
    ([("c1", "m", "a", True), ("c1", "m", "b", False)], ["b"]),
    # a lone first-pass record stays
    ([("c1", "m", "a", True)], ["a"]),
    # a sibling cell's refined record does not retire it
    ([("c1", "m", "a", True), ("c2", "m", "b", False)], ["a", "b"]),
    # nor does one of another mode of the same cell
    ([("c1", "m", "a", True), ("c1", "n", "b", False)], ["a", "b"]),
    # untagged records key by their surface
    ([(None, "m", "a", True), (None, "m", "a", False)], ["a"]),
])
def test_prefer_refined_agrees(pairs, kept):
    def recs(res):
        out = []
        for cell, mode, cmds, fp in pairs:
            env = {} if cell is None else {"TPU_PATTERNS_SWEEP_CONFIG": cell}
            if fp:
                env["TPU_PATTERNS_SWEEP_TIER"] = "first_pass"
            out.append(res.Record(pattern="p", mode=mode, commands=cmds,
                                  env=env))
        return out

    got = tr.prefer_refined(iter(recs(tr)))
    want = jr.prefer_refined(iter(recs(jr)))
    assert [(r.mode, r.commands, r.env) for r in got] == [
        (r.mode, r.commands, r.env) for r in want]
    assert [r.commands for r in got] == kept


def _rows(table: str) -> list[list[str]]:
    """A rendered table's env headers and cells, padding stripped."""
    out = []
    for ln in table.splitlines():
        if not ln.strip() or set(ln.replace("|", "").strip()) <= set("-:"):
            continue
        if ln.startswith("|"):
            out.append([c.strip() for c in ln.strip().strip("|").split("|")])
        else:
            out.append([ln.strip()])
    return out


def test_tabulate_records_rows_equal_the_references():
    got = tr.tabulate_records(tr.parse_log(_log(tr)))
    want = jr.tabulate_records(jr.parse_log(_log(jr)))
    assert _rows(got) == _rows(want)
    assert "SUPERSEDED [SUCCESS (tflops=10)]" in got
    assert "SUCCESS (bandwidth_GBps=1466) [NOISE-BOUND,NOT-HBM]" in got
    assert tr.tabulate_records([]) == jr.tabulate_records([]) == ""


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def test_report_cli_prints_the_references_table(tmp_path):
    log = tmp_path / "cell.log"
    log.write_text("".join(ln for ln in _log(tr) if "flash_grad" not in ln))
    rc, got, _ = _run(tcli.main, ["report", str(log)])
    jrc, want, _ = _run(jcli.main, ["report", str(log)])
    assert rc == jrc == 0
    assert _rows(got) == _rows(want)
    assert "| C C      |         | FAILURE        |" in got


def test_report_refuses_stale_grad_records(tmp_path):
    log = tmp_path / "grad.jsonl"
    log.write_text("".join(_log(tr)))
    rc, out, err = _run(tcli.main, ["report", str(log)])
    jrc, _, jerr = _run(jcli.main, ["report", str(log)])
    assert rc == jrc == 2
    assert out == ""
    assert err == jerr == (
        "# REFUSED: flash_grad | x predates the grad accounting fix and is "
        "not marked superseded\n")
