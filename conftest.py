"""Rules for the whole test suite under ``tests/``.

- Every test phase (setup, call, teardown) has a time limit of its own,
  so that a hang fails one test instead of cutting the whole run.
- The JAX package's tests of 85 s or more on the CPU carry the ``slow``
  marker (registered in ``pyproject.toml``): ``-m 'not slow'`` leaves them
  out, ``-m slow`` runs them.  Each behaviour they guard has a port
  counterpart that still runs, and the port's parity tests still run the
  JAX reference.
"""

import contextlib
import faulthandler
import signal
import sys
import threading
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent
TESTS = ROOT / "tests"

# The longest test that runs by default takes about 145 s on the CPU,
# about 200 s on a slow host.
TEST_TIME_LIMIT_S = 600

SLOW = frozenset({
    "tests/test_sharded_slam.py::test_composed_beyond_capacity_with_loop_at_parity",
    "tests/test_sharded_slam.py::test_composed_matches_single_device_with_loop",
    "tests/test_swap.py::test_sharded_sweep_beyond_aggregate_capacity_matches_uncapped",
    "tests/test_swap.py::test_corridor_sweep_beyond_capacity_matches_uncapped",
    "tests/test_reint_ring.py::test_ring_reintegration_full_rate_surface_quality",
    "tests/test_icl_format.py::test_icl_sequence_through_loader_and_app",
    "tests/test_multihost.py::test_kill_one_process_and_resume",
})


@contextlib.contextmanager
def time_limit(seconds):
    """Fail the block once it has run ``seconds``: SIGALRM raises
    ``pytest.fail`` where the main thread is, and ``faulthandler`` dumps
    every thread's stack at the same moment, in case the main thread is
    stuck in native code and never sees the signal.  Inside a block with
    an earlier limit, the earlier one holds; on exit the outer limit is
    armed again with what is left of it.  A no-op where there is no
    SIGALRM or off the main thread."""
    if not hasattr(signal, "SIGALRM") or threading.current_thread() is not threading.main_thread():
        yield
        return
    outer_left, _ = signal.getitimer(signal.ITIMER_REAL)
    if 0 < outer_left <= seconds:
        yield
        return

    def over(signum, frame):
        pytest.fail(f"ran past its time limit of {seconds} s")

    start = time.monotonic()
    old = signal.signal(signal.SIGALRM, over)
    try:
        signal.setitimer(signal.ITIMER_REAL, seconds)
        faulthandler.dump_traceback_later(seconds, exit=False, file=sys.__stderr__)
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, old)
        if outer_left:
            left = max(outer_left - (time.monotonic() - start), 1e-3)
            signal.setitimer(signal.ITIMER_REAL, left)
            faulthandler.dump_traceback_later(left, exit=False, file=sys.__stderr__)


@pytest.hookimpl(wrapper=True)
def _phase_time_limit(item):
    if TESTS not in item.path.parents:
        return (yield)
    with time_limit(TEST_TIME_LIMIT_S):
        return (yield)


pytest_runtest_setup = pytest_runtest_call = pytest_runtest_teardown = _phase_time_limit


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    """Mark ``SLOW`` before ``-m`` selects, which runs after this hook."""
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
