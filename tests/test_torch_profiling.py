"""``utils/profiling.py``: the step watchdog, the profiling window on
``torch.profiler`` and ``fenced_ms``.

* ``StepWatchdog`` with an injected clock: a step that runs past the
  timeout is logged (and ``timed_out`` set); one that ends in time is
  not; a timeout of 0 is refused (the trainer builds no watchdog then).
* ``ProfileWindow`` writes a CPU Chrome trace of exactly its window of
  global steps, is one-shot (a resumed run past the window never arms
  it), writes what it got when the run ends inside the window, and is a
  no-op without a directory.
"""

import json
import threading
import time

import pytest
import torch

from stochastic_gradient_push_torch.utils.profiling import (
    HEARTBEAT_TIMEOUT, ProfileWindow, StepWatchdog, fenced_ms)


class _Clock:
    def __init__(self):
        self.t = 100.0
        self.lock = threading.Lock()

    def __call__(self):
        with self.lock:
            return self.t

    def advance(self, dt):
        with self.lock:
            self.t += dt


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


def test_watchdog_logs_a_stalled_step(capsys):
    clock = _Clock()
    wd = StepWatchdog(timeout=300, rank=3, clock=clock, poll_s=0.005)
    with wd.step():
        clock.advance(299.0)
        time.sleep(0.05)
        assert not wd.timed_out
        clock.advance(2.0)    # the step has now run 301 s
        assert _wait(lambda: wd.timed_out)
    out = capsys.readouterr().out
    assert "step exceeded heartbeat timeout (301s > 300s)" in out
    assert out.startswith("3: ERROR")


def test_watchdog_is_quiet_on_a_step_in_time(capsys):
    clock = _Clock()
    wd = StepWatchdog(timeout=10, clock=clock, poll_s=0.005)
    for _ in range(3):
        with wd.step():
            clock.advance(9.0)
            time.sleep(0.02)
    # the watcher of an ended step never reports, whatever the clock does
    clock.advance(100.0)
    time.sleep(0.05)
    assert not wd.timed_out
    assert "heartbeat" not in capsys.readouterr().out


def test_watchdog_real_clock_and_refused_timeout():
    wd = StepWatchdog(timeout=0.1)
    with wd.step():
        time.sleep(0.35)
    assert wd.timed_out
    assert HEARTBEAT_TIMEOUT == 300
    with pytest.raises(ValueError, match="0 disables"):
        StepWatchdog(timeout=0)


def _steps(pw, steps):
    for k in steps:
        pw.maybe_start(k)
        with torch.profiler.record_function(f"marker_step_{k}"):
            torch.ones(8).sum()
        pw.maybe_stop(k)


def _markers(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(e["name"] for e in events
                  if str(e.get("name", "")).startswith("marker_step_"))


def test_profile_window_traces_exactly_its_window(tmp_path):
    pw = ProfileWindow(str(tmp_path / "prof"), start_step=2, num_steps=3,
                       device="cpu", rank=1)
    assert pw.enabled
    _steps(pw, range(8))
    assert pw.trace_path == str(tmp_path / "prof" / "trace_r1_steps2-4.json")
    assert _markers(pw.trace_path) == [
        "marker_step_2", "marker_step_3", "marker_step_4"]
    assert not pw.active
    # one shot: a later step does not re-arm it
    assert not pw.maybe_start(2)


def test_profile_window_skipped_past_never_arms(tmp_path):
    pw = ProfileWindow(str(tmp_path), start_step=2, num_steps=2)
    _steps(pw, range(5, 9))      # a resume that starts past the window
    assert pw.trace_path is None and not list(tmp_path.iterdir())


def test_profile_window_closed_inside_writes_what_it_got(tmp_path):
    pw = ProfileWindow(str(tmp_path), start_step=1, num_steps=5)
    _steps(pw, range(3))
    assert pw.active
    pw.close()
    assert not pw.active
    assert _markers(pw.trace_path) == ["marker_step_1", "marker_step_2"]


def test_profile_window_without_a_directory_is_a_no_op():
    pw = ProfileWindow(None)
    assert not pw.enabled
    _steps(pw, range(5))
    pw.close()
    assert pw.trace_path is None


def test_fenced_ms_times_a_call():
    ms = fenced_ms(lambda a: {"out": (a * 2, a)}, torch.ones(64), steps=3)
    assert ms > 0.0
