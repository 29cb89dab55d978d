"""Verbose logging + per-phase timing (reference: gfalibs Log `lg`
with --verbose, src/main.cpp:36-37; the reference has no profiler —
SURVEY.md §5.1 — so phase timers are first-class here)."""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager

verbose_flag = False
profile_flag = False
_start = time.perf_counter()
_phases: list = []
_last_write = time.monotonic()
_last_real = time.monotonic()
_hb_thread: threading.Thread | None = None


def _heartbeat_loop(interval: float, max_silent: float) -> None:
    """Emit a liveness line whenever nothing has been printed for
    `interval` seconds.  Long XLA compiles and device steps can run
    silent for minutes; watchdogs that key on log growth (batch
    schedulers, CI wrappers) would otherwise kill a healthy phase.

    Bounded: a heartbeat cannot tell "compiling" from "device hung"
    (both are silent Python-side), so after `max_silent` seconds with
    no REAL message the loop announces it is standing down and exits —
    the log stops growing and the watchdog's hang detection works
    again."""
    global _last_write
    while True:
        time.sleep(interval)
        if not verbose_flag:
            continue
        silent = time.monotonic() - _last_real
        if silent > max_silent:
            elapsed = time.perf_counter() - _start
            sys.stderr.write(f"[{elapsed:8.2f}s] ... heartbeat: no real "
                             f"output for {silent:.0f}s (> bound "
                             f"{max_silent:.0f}s); standing down so the "
                             f"stall watchdog can act\n")
            sys.stderr.flush()
            return
        idle = time.monotonic() - _last_write
        if idle >= interval:
            elapsed = time.perf_counter() - _start
            sys.stderr.write(f"[{elapsed:8.2f}s] ... heartbeat: alive, "
                             f"{silent:.0f}s since last message "
                             f"(likely compiling or in a long device "
                             f"step)\n")
            sys.stderr.flush()
            _last_write = time.monotonic()


def _maybe_start_heartbeat() -> None:
    global _hb_thread
    if _hb_thread is not None and _hb_thread.is_alive():
        return
    interval = float(os.environ.get("KREEQ_TPU_HEARTBEAT_S", "120"))
    if interval <= 0:
        return
    max_silent = float(
        os.environ.get("KREEQ_TPU_HEARTBEAT_MAX_SILENT_S", "3000"))
    _hb_thread = threading.Thread(
        target=_heartbeat_loop, args=(interval, max_silent), daemon=True)
    _hb_thread.start()


def set_flags(verbose: bool = False, profile: bool = False) -> None:
    global verbose_flag, profile_flag
    verbose_flag = verbose
    profile_flag = profile
    if verbose:
        _maybe_start_heartbeat()


def verbose(msg: str) -> None:
    if verbose_flag:
        global _last_write, _last_real
        elapsed = time.perf_counter() - _start
        sys.stderr.write(f"[{elapsed:8.2f}s] {msg}\n")
        _last_write = _last_real = time.monotonic()
        # A real message proves the phase is making progress; re-arm
        # the heartbeat if a previous long silence stood it down.
        if _hb_thread is not None and not _hb_thread.is_alive():
            _maybe_start_heartbeat()


@contextmanager
def phase(name: str):
    """Time a pipeline phase; report with print_profile()."""
    t0 = time.perf_counter()
    verbose(f"{name}...")
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _phases.append((name, dt))
        verbose(f"{name} done in {dt:.3f}s")


def print_profile() -> None:
    if profile_flag and _phases:
        sys.stderr.write("=== phase profile ===\n")
        for name, dt in _phases:
            sys.stderr.write(f"{name:<30s} {dt * 1e3:10.1f} ms\n")


def maybe_start_jax_profiler(trace_dir: str) -> None:
    """Capture a jax.profiler trace for the run when requested."""
    import jax

    jax.profiler.start_trace(trace_dir)


def maybe_stop_jax_profiler() -> None:
    import jax

    jax.profiler.stop_trace()
