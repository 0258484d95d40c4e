"""Guards of the test suite itself: the per-phase time limit and the set
of tests marked ``slow`` (both in the repository's root ``conftest.py``),
which the tier-1 command (``-m 'not slow'``) leaves out."""

import importlib.util
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _suite_rules(name="suite_rules"):
    """A fresh copy of the root ``conftest.py``, to change its settings in."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "conftest.py")
    rules = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rules)
    return rules


needs_alarm = pytest.mark.skipif(not hasattr(signal, "SIGALRM"), reason="no SIGALRM here")


def _left():
    return signal.getitimer(signal.ITIMER_REAL)[0]


@needs_alarm
def test_a_sleep_past_the_limit_fails_within_it(capfd):
    """A 1 s limit inside this test's own phase limit: the sleep fails
    within about 1 s, and on exit the phase limit is armed again with what
    is left of it, under its own handler."""
    time_limit = _suite_rules().time_limit
    handler, before, t0 = signal.getsignal(signal.SIGALRM), _left(), time.monotonic()
    assert before > 0, "the suite's phase limit is not armed"
    with pytest.raises(pytest.fail.Exception, match="time limit of 1 s"):
        with time_limit(1):
            time.sleep(5)
    took = time.monotonic() - t0
    assert 0.9 < took < 2, took
    assert signal.getsignal(signal.SIGALRM) is handler
    assert _left() == pytest.approx(max(before - took, 0), abs=0.5)

    # A main thread that cannot take the signal, as in native code, still
    # has its stack dumped at the limit, and fails once it takes the signal.
    capfd.readouterr()
    with pytest.raises(pytest.fail.Exception, match="time limit of 0.3 s"):
        with time_limit(0.3):
            signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
            try:
                time.sleep(0.6)
            finally:
                signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGALRM})
    assert "test_a_sleep_past_the_limit_fails_within_it" in capfd.readouterr().err

    # A block that ends in time leaves no dump of its own behind.
    with time_limit(0.2):
        pass
    time.sleep(0.3)
    assert "Timeout" not in capfd.readouterr().err
    assert signal.getsignal(signal.SIGALRM) is handler


@needs_alarm
def test_a_test_past_its_limit_fails_alone_and_the_run_goes_on(tmp_path):
    """The suite's hooks in a session of their own, with the limit at 1 s:
    the sleeping test fails with the limit's message, the next one passes,
    and this test's own phase limit is armed again afterwards."""
    (tmp_path / "test_two.py").write_text(
        "import time\n\n"
        "def test_sleeps():\n    time.sleep(5)\n\n"
        "def test_runs_on():\n    pass\n")
    rules = _suite_rules()
    rules.TEST_TIME_LIMIT_S, rules.TESTS = 1, tmp_path

    class Outcomes:
        def __init__(self):
            self.calls = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call":
                self.calls[report.head_line] = report

    outcomes = Outcomes()
    handler, before, t0 = signal.getsignal(signal.SIGALRM), _left(), time.monotonic()
    rc = pytest.main([str(tmp_path / "test_two.py"), "-q", "--rootdir", str(tmp_path),
                      "-p", "no:cacheprovider", "-p", "no:xdist", "-p", "no:randomly"],
                     plugins=[rules, outcomes])
    assert rc == pytest.ExitCode.TESTS_FAILED
    sleeps, runs_on = outcomes.calls["test_sleeps"], outcomes.calls["test_runs_on"]
    assert sleeps.failed and "ran past its time limit of 1 s" in sleeps.longreprtext
    assert 0.9 < sleeps.duration < 2, sleeps.duration
    assert runs_on.passed
    assert signal.getsignal(signal.SIGALRM) is handler
    assert _left() == pytest.approx(max(before - (time.monotonic() - t0), 0), abs=0.5)


def test_exactly_the_seven_reference_tests_are_slow():
    """``-m slow`` collects the seven JAX-reference tests and nothing
    else: no port test and no test outside ``tests/``."""
    slow = _suite_rules().SLOW
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-m", "pytest", "tests/", "--collect-only", "-q", "-m", "slow",
                        "-p", "no:cacheprovider", "-p", "no:randomly"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    collected = {line for line in r.stdout.splitlines() if "::" in line}
    assert collected == slow, (sorted(collected - slow), sorted(slow - collected))
    assert len(slow) == 7
    assert not [t for t in slow if not t.startswith("tests/test_") or t.startswith("tests/test_torch_")]
