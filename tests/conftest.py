"""Suite-wide hang protection: a faulthandler-based ``pytest-timeout``
equivalent (the container has no pytest-timeout wheel, and the tier-1
suite now includes resilience tests that *deliberately* hang a transfer
worker — a regression there must fail with a stack trace, not wedge CI).

Two layers per test, both configured by ``REPRO_TEST_TIMEOUT_S`` (default
600 s, generous against cold-compile tests on a loaded container; ``0``
disables):

* a ``SIGALRM`` timer that raises a pytest failure *inside* the test on
  expiry — the traceback shows exactly where the test was stuck and the
  rest of the suite keeps running;
* a ``faulthandler.dump_traceback_later`` backstop at 2× the budget that
  dumps every thread's stack and hard-exits — for the case where the main
  thread itself is wedged in non-interruptible C code (a jitted XLA call,
  a hung ``device_put``) and the Python-level signal handler never runs.

POSIX-only (SIGALRM); on other platforms the guard is a no-op. Tests may
override their budget with ``@pytest.mark.timeout_s(30)``.
"""
from __future__ import annotations

import faulthandler
import os
import signal

import pytest

DEFAULT_TIMEOUT_S = float(os.environ.get("REPRO_TEST_TIMEOUT_S", "600"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "timeout_s(seconds): per-test wall-clock budget enforced by the "
        "SIGALRM hang guard (see tests/conftest.py)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; the test skips itself where none is "
        "present (run on the card: python -m pytest -m gpu tests/)")


@pytest.fixture(autouse=True)
def _hang_guard(request):
    budget = DEFAULT_TIMEOUT_S
    marker = request.node.get_closest_marker("timeout_s")
    if marker is not None:
        budget = float(marker.args[0])
    if budget <= 0 or not hasattr(signal, "SIGALRM"):
        yield
        return

    def _on_alarm(signum, frame):
        pytest.fail(f"test exceeded its {budget:g}s wall-clock budget "
                    f"(hang guard; raise with @pytest.mark.timeout_s or "
                    f"REPRO_TEST_TIMEOUT_S)")

    old_handler = signal.signal(signal.SIGALRM, _on_alarm)
    signal.setitimer(signal.ITIMER_REAL, budget)
    faulthandler.dump_traceback_later(budget * 2, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old_handler)
