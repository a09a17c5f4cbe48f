"""/proc process statistics (reference pkg/metrics/tool/stat.go).

CPU utilization is computed as delta(process jiffies)/delta(total jiffies)
between two samples, RSS from statm, fd/thread counts from /proc/<pid>.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
_CLK_TCK = os.sysconf("SC_CLK_TCK")


@dataclass
class ProcessStat:
    utime: float  # seconds in user mode
    stime: float  # seconds in kernel mode
    threads: int
    start_time: float  # seconds after boot


def read_process_stat(pid: int) -> ProcessStat:
    with open(f"/proc/{pid}/stat", "rb") as f:
        data = f.read().decode()
    # comm may contain spaces/parens; fields start after the closing paren.
    rest = data[data.rindex(")") + 2 :].split()
    # rest[0] is field 3 (state); utime=14, stime=15, num_threads=20, starttime=22
    return ProcessStat(
        utime=int(rest[11]) / _CLK_TCK,
        stime=int(rest[12]) / _CLK_TCK,
        threads=int(rest[17]),
        start_time=int(rest[19]) / _CLK_TCK,
    )


def total_cpu_jiffies() -> int:
    with open("/proc/stat", "rb") as f:
        first = f.readline().decode().split()
    return sum(int(x) for x in first[1:])


def get_process_memory_rss_kb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/statm", "rb") as f:
            rss_pages = int(f.read().split()[1])
        return rss_pages * _PAGE_SIZE / 1024.0
    except (OSError, IndexError, ValueError):
        return 0.0


def get_fd_count(pid: int) -> int:
    try:
        return len(os.listdir(f"/proc/{pid}/fd"))
    except OSError:
        return 0


def get_thread_count(pid: int) -> int:
    try:
        return read_process_stat(pid).threads
    except (OSError, ValueError):
        return 0


def run_time_seconds(pid: int) -> float:
    try:
        st = read_process_stat(pid)
        with open("/proc/uptime", "rb") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - st.start_time)
    except (OSError, ValueError):
        return 0.0


class CPUSampler:
    """Two-point CPU utilization sampling (stat.go CalculateCPUUtilization):
    call sample() periodically; utilization() is % between last two samples."""

    def __init__(self, pid: int):
        self.pid = pid
        self._last: Optional[tuple[float, int]] = None
        self._util = 0.0

    def sample(self) -> float:
        try:
            st = read_process_stat(self.pid)
            total = total_cpu_jiffies()
        except (OSError, ValueError):
            return self._util
        proc_jiffies = (st.utime + st.stime) * _CLK_TCK
        if self._last is not None:
            dp = proc_jiffies - self._last[0]
            dt = total - self._last[1]
            if dt > 0:
                self._util = 100.0 * dp / dt * os.cpu_count()
        self._last = (proc_jiffies, total)
        return self._util

    def utilization(self) -> float:
        return self._util


def measure_startup_cpu(pid: int, duration_sec: float, sleep=time.sleep) -> float:
    """Startup CPU utilization over a window (daemon_adaptor.go:53-72)."""
    sampler = CPUSampler(pid)
    sampler.sample()
    sleep(duration_sec)
    return sampler.sample()
