"""Watchdog for device-to-host pulls that may never return.

A pull from the device (``.cpu()``, ``float(t)``) waits for every kernel
queued before it. Should the device or its driver wedge, that wait lasts
forever: the process neither fails nor makes progress, and every later
pull queues behind it. The recovery is to end the process with a
distinctive exit code and let a wrapper relaunch it, resuming from the
newest checkpoint (:mod:`..tools.resilient_run`).

Opt-in through ``DVGO_FETCH_WATCHDOG=<seconds>``: unset or 0, every guard
is a no-op and no thread starts. Each guarded pull registers a deadline; a
daemon thread scans every 2 s and, when an active pull is overdue, takes
the lock again, confirms that the pull is still active and still overdue,
and only then calls ``os._exit(EXIT_WEDGED)``, so a pull that left its
guard after its deadline but before the scan does not kill a healthy
process. ``os._exit`` is deliberate: the wedged call holds the runtime's
locks, and a clean shutdown would itself hang.

Guards sit around the pulls alone, never around work that may build a
kernel first (a first use compiles with ``nvcc`` for tens of seconds).
"""

from __future__ import annotations

import os
import sys
import threading
import time

EXIT_WEDGED = 17
SCAN_S = 2.0

_state = {
    "lock": threading.Lock(),
    "active": {},      # key -> (t_start, timeout_s, label)
    "thread": None,
    "n": 0,
    "on_abort": None,  # host-only callback run before the exit
}


def set_abort_callback(fn):
    """Register ``fn(label)``, run right before ``os._exit``. It must not
    touch the device: any device call would queue behind the wedge."""
    _state["on_abort"] = fn


def timeout_default():
    """The configured watchdog seconds (0: disabled)."""
    try:
        return float(os.environ.get("DVGO_FETCH_WATCHDOG", "0") or "0")
    except ValueError:
        return 0.0


def _overdue(now):
    """(key, seconds, timeout, label) of the first active pull past its
    deadline at ``now``, or None. Call with the lock held."""
    for key, (t0, tmo, label) in _state["active"].items():
        if now - t0 > tmo:
            return key, now - t0, tmo, label
    return None


def _abort(stuck, tmo, label):
    print(f"fetchguard: device-to-host pull '{label}' stuck {stuck:.0f} s "
          f"(> {tmo:.0f} s); aborting for resume (exit {EXIT_WEDGED})",
          file=sys.stderr, flush=True)
    cb = _state["on_abort"]
    if cb is not None:
        try:
            cb(label)
        except Exception as e:  # the callback must not keep us alive
            print(f"fetchguard: abort callback failed: {e!r}",
                  file=sys.stderr, flush=True)
    try:
        sys.stdout.flush()
    except Exception:
        pass
    os._exit(EXIT_WEDGED)


def _scan_once():
    """One scan: exit if a pull is overdue now and still is under the lock
    right before the exit."""
    with _state["lock"]:
        found = _overdue(time.time())
    if found is None:
        return
    key = found[0]
    with _state["lock"]:
        entry = _state["active"].get(key)
        now = time.time()
        if entry is None or now - entry[0] <= entry[1]:
            return           # the pull left its guard meanwhile
        _abort(now - entry[0], entry[1], entry[2])


def _watch():
    while True:
        time.sleep(SCAN_S)
        _scan_once()


class guarded:
    """Context manager around a device-to-host pull that the watchdog
    covers. ``timeout`` overrides ``DVGO_FETCH_WATCHDOG`` for this pull
    (large pulls, checkpoints and eval frames, get more)."""

    def __init__(self, label, timeout=None):
        self.timeout = timeout_default() if timeout is None else timeout
        self.label = label
        self.key = None

    def __enter__(self):
        if self.timeout <= 0:
            return self
        with _state["lock"]:
            _state["n"] += 1
            self.key = _state["n"]
            _state["active"][self.key] = (time.time(), self.timeout,
                                          self.label)
            if _state["thread"] is None:
                th = threading.Thread(target=_watch, daemon=True,
                                      name="fetchguard")
                _state["thread"] = th
                th.start()
        return self

    def __exit__(self, *exc):
        if self.key is not None:
            with _state["lock"]:
                _state["active"].pop(self.key, None)
        return False


def _pull(tree):
    if isinstance(tree, dict):
        return {k: _pull(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_pull(v) for v in tree)
    return tree.cpu() if hasattr(tree, "cpu") else tree


def guarded_get(tree, label, timeout=None):
    """``tree`` (tensors in dicts, lists and tuples) with every tensor
    pulled to the host by ``.cpu()``, under the watchdog."""
    with guarded(label, timeout):
        return _pull(tree)
