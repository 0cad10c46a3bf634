"""The card's SM clock and power draw through the window, for the log.

``nvidia-smi`` samples them every half second while the context is open;
the summary goes to standard error beside the run's result, so that a
slow run can be told from a slow card. No metric reads it.
"""

from __future__ import annotations

import statistics
import subprocess


class Clocks:
    def __init__(self, period_ms=500):
        self.period_ms = period_ms
        self.proc = None
        self.samples = []

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", "-lms",
                 str(self.period_ms)], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            return
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        for line in out.splitlines():
            try:
                mhz, watts = (float(v) for v in line.split(","))
            except ValueError:
                continue
            self.samples.append((mhz, watts))

    def summary(self):
        if not self.samples:
            return "no clock samples"
        mhz = sorted(s[0] for s in self.samples)
        watts = statistics.median(s[1] for s in self.samples)
        return (f"SM clock {mhz[0]:.0f} / {statistics.median(mhz):.0f} / "
                f"{mhz[-1]:.0f} MHz (min / median / max), power "
                f"{watts:.0f} W median, {len(mhz)} samples")
