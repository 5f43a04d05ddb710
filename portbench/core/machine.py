"""What the card and the host were doing during a run's window, on an
earlier line of the run: the card's SM and memory clocks, power,
temperature and clock-event (throttle) reasons, sampled by `nvidia-smi`
every half second, and the host's steal time (the share of its cores'
time the hypervisor gave to others), load and the run's own CPU time and
involuntary context switches. A window that ran slow shows here whether
the card or the host held it back."""
from __future__ import annotations

import os
import resource
import subprocess

FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu",
          "clocks_throttle_reasons.active")
PERIOD_MS = 500


def _cpu_times():
    """(steal, total) jiffies of all cores, from /proc/stat (None where
    the file is missing)."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None
    return (v[7] if len(v) > 7 else 0), sum(v[:8])


class Sampler:
    """start() at the window's start, stop() -> summary dict at its end."""

    def __init__(self, card=True):
        self.card, self.proc = card, None

    def start(self):
        self.cpu0, self.ru0 = _cpu_times(), resource.getrusage(resource.RUSAGE_SELF)
        if not self.card:
            return
        fields = FIELDS
        try:  # an older nvidia-smi may not know the reasons' field
            if subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={','.join(fields)}",
                               "--format=csv,noheader,nounits"], capture_output=True,
                              timeout=20).returncode:
                fields = FIELDS[:-1]
            self.proc = subprocess.Popen(
                ["nvidia-smi", "-i", "0", f"--query-gpu={','.join(fields)}",
                 "--format=csv,noheader,nounits", f"-lms={PERIOD_MS}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except (OSError, subprocess.SubprocessError):
            self.proc = None

    def stop(self):
        ru, cpu = resource.getrusage(resource.RUSAGE_SELF), _cpu_times()
        out = dict(process_cpu_s=ru.ru_utime + ru.ru_stime - self.ru0.ru_utime - self.ru0.ru_stime,
                   involuntary_switches=ru.ru_nivcsw - self.ru0.ru_nivcsw,
                   load_1min=os.getloadavg()[0])
        if cpu and self.cpu0 and cpu[1] > self.cpu0[1]:
            out["host_steal_pct"] = 100.0 * (cpu[0] - self.cpu0[0]) / (cpu[1] - self.cpu0[1])
        if self.proc is not None:
            self.proc.terminate()
            try:
                text, _ = self.proc.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                text, _ = self.proc.communicate()
            out.update(_card(text))
        return out


def _card(text):
    rows = []
    for line in text.splitlines():
        parts = [p.strip() for p in line.split(",")]
        try:
            rows.append([float(p) for p in parts[:4]] + parts[4:5])
        except ValueError:
            continue
    if not rows:
        return {}
    sm = sorted(r[0] for r in rows)
    reasons = 0
    for r in rows:
        if len(r) > 4:
            try:
                reasons |= int(r[4], 16)
            except ValueError:
                pass
    return dict(card_samples=len(rows), sm_mhz_min=sm[0], sm_mhz_median=sm[len(sm) // 2],
                sm_mhz_max=sm[-1], mem_mhz_min=min(r[1] for r in rows),
                power_w_median=sorted(r[2] for r in rows)[len(rows) // 2],
                power_w_max=max(r[2] for r in rows), temperature_c_max=max(r[3] for r in rows),
                clock_event_reasons=hex(reasons))
