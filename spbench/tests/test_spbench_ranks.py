"""The gang (``spbench/gang.py``, ``run.py``'s launcher) on the CPU: toy
gangs of 2 and 4 ranks on gloo (``gang_toy.py``), each a fresh launcher
process. Every rank runs the same units, a failing rank ends the gang
with no result, one result line carries the gathered readings, and a cell
on one card still runs in-process."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from spbench import gang, harness
from toy import cell

TOY = Path(__file__).with_name("gang_toy.py")
SEED = 2 ** 31 + 11


def _gang(world: int, traffic: dict, seconds: float, trace: int = 0):
    """``(completed process, seconds it took)`` of one toy gang."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop(gang.T0_ENV, None)
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, str(TOY), "--world", str(world), "--seed",
         str(SEED), "--seconds", str(seconds), "--trace", str(trace),
         "--traffic", json.dumps(traffic)],
        capture_output=True, text=True, timeout=115, env=env)
    return out, time.monotonic() - t0


def _rank0_notes(err: str) -> dict:
    prefix = "[rank 0] notes: "
    lines = [s for s in err.splitlines() if s.startswith(prefix)]
    assert len(lines) == 1, err[-3000:]
    return json.loads(lines[0][len(prefix):])


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_runs_the_same_units(world):
    """The last rank's units take 20 ms longer; the window still ends on
    rank 0's clock and every rank has run as many units."""
    out, _ = _gang(world, {"slow_rank": world - 1, "slow_s": 0.02}, 1.0)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout)
    assert line["correct"] is True and line["attempted"] > 1
    units = [r["units"] for r in _rank0_notes(out.stderr)["ranks"]]
    assert units == [line["attempted"]] * world


@pytest.mark.parametrize("world,traffic", [
    (2, {"fail_at": "setup"}),
    (2, {"fail_at": "unit"}),
    (2, {"fail_at": "check"}),
    (2, {"fail_at": "killed"}),
    # rank 0 sleeps where it would otherwise notice: the launcher ends it
    (2, {"fail_at": "setup", "slow_rank": 0, "slow_s": 600}),
    (4, {"fail_at": "unit"}),
], ids=["setup", "unit", "check", "killed", "peer-asleep", "unit-4"])
def test_a_failing_rank_ends_the_gang(world, traffic):
    out, seconds = _gang(world, dict(traffic, fail_rank=world - 1), 5.0)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert seconds < 60
    assert f"rank {world - 1} exited with" in out.stderr


@pytest.mark.parametrize("world", [2, 4])
def test_one_result_line_from_every_rank(world):
    """Traced: rank r reports 1000·(r + 1) peak bytes and ends its window
    r·50 ms later; the result is one line, its peak the largest, the
    reader's trace rank 0's, the compared numbers the last lines of
    standard error."""
    out, _ = _gang(world, {"fake_peak": True, "sync_sleep_s": 0.05}, 0.5,
                   trace=1)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == [*harness.RESULT_KEYS, "breakdown", "checks"]
    assert line["correct"] is True
    assert line["device"]["count"] == world
    assert line["device"]["memory_peak_bytes"] == 1000 * world
    ranks = _rank0_notes(out.stderr)["ranks"]
    assert [r["peak_bytes"] for r in ranks] == [1000 * (r + 1)
                                               for r in range(world)]
    assert len({r["window_s"] for r in ranks}) == world
    assert line["metrics"]["trace_window_s"]["value"] == ranks[0]["window_s"]
    checks = line["checks"]
    assert out.stderr.strip().splitlines()[-len(checks):] == [
        f"check {k} {c['value']!r} limit {c['limit']!r}"
        for k, c in checks.items()]


def test_one_card_runs_in_process(cpu, monkeypatch, capsys):
    """A cell on one card: no launcher, no process started, and the result
    line's keys as ``harness.run_cell`` gives them."""
    from spbench import run

    def no_process(*args, **kwargs):
        raise AssertionError("a cell on one card started a process")

    monkeypatch.delenv(gang.T0_ENV, raising=False)
    monkeypatch.setattr(subprocess, "Popen", no_process)
    monkeypatch.setattr(gang, "launch", no_process)
    rc = run.run(cell("cg"), SEED, 0.05, False, time.time(), lambda i: cpu,
                 [sys.executable, "unused"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == [*harness.RESULT_KEYS, "checks"]
    assert line["correct"] is True and line["device"]["count"] == 1
