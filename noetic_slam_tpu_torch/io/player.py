"""Interactive dataset player — terminal re-design of the Qt file player.

The reference's MulRan player is a Qt5 GUI (MainWindow,
src/file_player_mulran/src/mainwindow.cpp:6-206) whose controls signal into
a 0.1 ms-timer pacing loop (ROSThread.cpp:287-399,454-467): play/pause,
playback-speed spinbox, loop checkbox, skip-stop-region, and a position
slider that calls ResetProcessStamp to seek (ROSThread.cpp:693-700). This
module provides the same control surface without a display server: a
keyboard-driven terminal player (raw-mode stdin reader thread + a status
line), with every control also exposed as a method so headless/automated
use (and tests) can drive it programmatically.

Controls (keyboard, when stdin is a TTY):
  space  pause / resume
  + / -  playback rate x2 / /2 (the GUI's speed spinbox)
  l      toggle loop (the GUI's loop checkbox)
  0-9    seek to that tenth of the dataset (the GUI's slider)
  q      quit

Unlike the wall-clock-driven reference, event ORDER stays deterministic:
pacing only delays dispatch; seek/loop reset the pace baseline. Consumers
see the same callbacks as io.replay.replay_dataset.

The port's own copy of ``noetic_slam_tpu.io.player`` (it imports nothing of
the JAX package); ``tests/test_torch_live.py`` holds it to the original.
"""

from __future__ import annotations

import bisect
import sys
import threading
import time
from typing import Callable, Optional


class PlayerControls:
    """Shared control state (thread-safe via the GIL; single writer each)."""

    def __init__(self, rate: float = 1.0, loop: bool = False):
        self.rate = rate
        self.paused = False
        self.loop = loop
        self.quit = False
        self.seek_frac: Optional[float] = None   # pending seek, 0..1

    # -- the GUI's control signals --
    def toggle_pause(self):
        self.paused = not self.paused

    def speed_up(self):
        self.rate = min(self.rate * 2.0, 64.0)

    def slow_down(self):
        self.rate = max(self.rate / 2.0, 1.0 / 64.0)

    def toggle_loop(self):
        self.loop = not self.loop

    def seek(self, frac: float):
        self.seek_frac = min(max(frac, 0.0), 1.0)

    def stop(self):
        self.quit = True


def _keyboard_thread(controls: PlayerControls):
    """Raw-mode stdin reader (daemon). Restores terminal state on exit."""
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        while not controls.quit:
            ch = sys.stdin.read(1)
            if ch == " ":
                controls.toggle_pause()
            elif ch == "+":
                controls.speed_up()
            elif ch == "-":
                controls.slow_down()
            elif ch == "l":
                controls.toggle_loop()
            elif ch.isdigit():
                controls.seek(int(ch) / 10.0)
            elif ch == "q":
                controls.stop()
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


class InteractivePlayer:
    """Paced, controllable event dispatcher over a dataset.

    ``dataset`` needs ``events()`` yielding (stamp, kind, index) in time
    order (io.mulran.MulranDataset interface). Callbacks:
      on_event(stamp, kind, idx)  — every dispatched event
      on_seek(stamp)              — after a seek lands (consumer may reset)
      on_loop()                   — when playback wraps (loop mode)
    ``skip_stop_region`` (t0, t1): events inside the absolute window are
    dropped (the reference's stop-section skip, ROSThread.cpp:330-350).
    """

    def __init__(self, dataset, on_event: Callable,
                 rate: float = 1.0, loop: bool = False,
                 on_seek: Optional[Callable] = None,
                 on_loop: Optional[Callable] = None,
                 skip_stop_region: Optional[tuple] = None,
                 keyboard: bool = False, status: bool = False):
        self.events = list(dataset.events())
        if not self.events:
            raise ValueError("dataset has no events")
        self.stamps = [e[0] for e in self.events]
        self.on_event = on_event
        self.on_seek = on_seek
        self.on_loop = on_loop
        self.skip = skip_stop_region
        self.controls = PlayerControls(rate=rate, loop=loop)
        self.keyboard = keyboard and sys.stdin.isatty()
        self.status = status
        self.position = 0                     # next event index
        self.n_dispatched = 0
        # pacing baseline (data time <-> wall time at the current rate)
        self._base_wall = None
        self._base_data = None

    # ------------------------------------------------------------- pacing
    def _rebase(self, stamp: float):
        self._base_wall = time.monotonic()
        self._base_data = stamp

    def _pace(self, stamp: float):
        rate = self.controls.rate
        if rate <= 0:
            return
        if self._base_wall is None:
            self._rebase(stamp)
            return
        target = self._base_wall + (stamp - self._base_data) / rate
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(min(delay, 0.25))
            if delay > 0.25:                  # re-check controls mid-wait
                self._pace(stamp)

    # -------------------------------------------------------------- status
    def _print_status(self, stamp: float):
        t0, t1 = self.stamps[0], self.stamps[-1]
        frac = (stamp - t0) / max(t1 - t0, 1e-9)
        c = self.controls
        sys.stderr.write(
            f"\r[{'PAUSED' if c.paused else 'play  '}] "
            f"{frac * 100.0:5.1f}%  t={stamp - t0:8.2f}s  "
            f"rate x{c.rate:g}  loop={'on' if c.loop else 'off'}  "
            f"({self.n_dispatched} events)   ")
        sys.stderr.flush()

    # ----------------------------------------------------------------- run
    def run(self, max_events: Optional[int] = None) -> dict:
        """Dispatch until the end of data (or quit/max_events). Returns
        {"n_events", "loops", "wall_time"}."""
        kb = None
        if self.keyboard:
            kb = threading.Thread(target=_keyboard_thread,
                                  args=(self.controls,), daemon=True)
            kb.start()
        c = self.controls
        loops = 0
        t_start = time.perf_counter()
        last_status = 0.0
        while not c.quit:
            if c.seek_frac is not None:
                frac, c.seek_frac = c.seek_frac, None
                t0, t1 = self.stamps[0], self.stamps[-1]
                target = t0 + frac * (t1 - t0)
                self.position = bisect.bisect_left(self.stamps, target)
                self.position = min(self.position, len(self.events) - 1)
                self._rebase(self.stamps[self.position])
                if self.on_seek is not None:
                    self.on_seek(self.stamps[self.position])
            if c.paused:
                if self.status:
                    self._print_status(
                        self.stamps[min(self.position,
                                        len(self.stamps) - 1)])
                time.sleep(0.05)
                self._base_wall = None        # rebase on resume
                continue
            if self.position >= len(self.events):
                if c.loop:
                    loops += 1
                    self.position = 0
                    self._base_wall = None
                    if self.on_loop is not None:
                        self.on_loop()
                    continue
                break
            stamp, kind, idx = self.events[self.position]
            self.position += 1
            if self.skip and self.skip[0] <= stamp <= self.skip[1]:
                continue
            self._pace(stamp)
            if c.seek_frac is not None or c.quit:
                continue                      # control arrived mid-wait
            self.on_event(stamp, kind, idx)
            self.n_dispatched += 1
            if max_events is not None and self.n_dispatched >= max_events:
                break
            if self.status and time.monotonic() - last_status > 0.2:
                last_status = time.monotonic()
                self._print_status(stamp)
        if self.status:
            sys.stderr.write("\n")
        return {"n_events": self.n_dispatched, "loops": loops,
                "wall_time": time.perf_counter() - t_start}
