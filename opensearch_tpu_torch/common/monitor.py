"""Monitor service: os / process / fs / memory probes.

The analog of the reference's monitor package
(server/src/main/java/org/opensearch/monitor/ — OsService, ProcessProbe,
FsService, JvmService; cached probes refreshed on an interval feed
_nodes/stats, _cluster/stats, and the disk-threshold allocation decider).
Pure-stdlib Linux probes: /proc for cpu/memory, shutil.disk_usage for fs.
"""

from __future__ import annotations

import os
import resource
import shutil
import time
from pathlib import Path
from typing import Any

_REFRESH_S = 1.0


class MonitorService:
    """Cached system probes (OsProbe/ProcessProbe/FsProbe)."""

    def __init__(self, data_path: Path | None = None):
        self.data_path = Path(data_path) if data_path else Path(".")
        self._cache: dict[str, Any] = {}
        self._cached_at = 0.0
        self._start_time = time.time()

    def _probe(self) -> dict[str, Any]:
        now = time.time()
        if self._cache and now - self._cached_at < _REFRESH_S:
            return self._cache
        self._cache = {
            "os": self._os_stats(),
            "process": self._process_stats(),
            "fs": self.fs_stats(),
        }
        self._cached_at = now
        return self._cache

    # -- probes ------------------------------------------------------------

    def _os_stats(self) -> dict:
        try:
            load1, load5, load15 = os.getloadavg()
        except OSError:  # pragma: no cover
            load1 = load5 = load15 = 0.0
        mem_total = mem_free = mem_available = 0
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    parts = line.split()
                    if parts[0] == "MemTotal:":
                        mem_total = int(parts[1]) * 1024
                    elif parts[0] == "MemFree:":
                        mem_free = int(parts[1]) * 1024
                    elif parts[0] == "MemAvailable:":
                        mem_available = int(parts[1]) * 1024
        except OSError:  # pragma: no cover
            pass
        used = mem_total - mem_available if mem_total else 0
        return {
            "timestamp": int(time.time() * 1000),
            "cpu": {
                "percent": -1,  # point-in-time cpu% needs two samples
                "load_average": {"1m": load1, "5m": load5, "15m": load15},
            },
            "mem": {
                "total_in_bytes": mem_total,
                "free_in_bytes": mem_free,
                "used_in_bytes": used,
                "free_percent": (round(100 * mem_available / mem_total)
                                 if mem_total else 0),
                "used_percent": (round(100 * used / mem_total)
                                 if mem_total else 0),
            },
        }

    def _process_stats(self) -> dict:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        open_fds = 0
        try:
            open_fds = len(os.listdir("/proc/self/fd"))
        except OSError:  # pragma: no cover
            pass
        max_fds = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
        return {
            "timestamp": int(time.time() * 1000),
            "open_file_descriptors": open_fds,
            "max_file_descriptors": max_fds,
            "cpu": {
                "total_in_millis": int(
                    (ru.ru_utime + ru.ru_stime) * 1000
                ),
            },
            "mem": {
                # ru_maxrss is KiB on Linux
                "resident_in_bytes": ru.ru_maxrss * 1024,
            },
            "uptime_in_millis": int((time.time() - self._start_time) * 1000),
        }

    def fs_stats(self) -> dict:
        """Disk usage of the data path (FsProbe; feeds the disk-threshold
        decider's watermark math)."""
        try:
            usage = shutil.disk_usage(
                self.data_path if self.data_path.exists() else Path(".")
            )
            total, free = usage.total, usage.free
        except OSError:  # pragma: no cover
            total = free = 0
        return {
            "timestamp": int(time.time() * 1000),
            "total": {
                "total_in_bytes": total,
                "free_in_bytes": free,
                "available_in_bytes": free,
            },
            "data": [{
                "path": str(self.data_path),
                "mount": "/",
                "type": "overlay",
                "total_in_bytes": total,
                "free_in_bytes": free,
                "available_in_bytes": free,
            }],
        }

    # -- public views ------------------------------------------------------

    def stats(self) -> dict:
        return dict(self._probe())

    def info(self) -> dict:
        return {
            "os": {
                "name": os.uname().sysname,
                "arch": os.uname().machine,
                "version": os.uname().release,
                "available_processors": os.cpu_count() or 1,
            },
            "process": {
                "id": os.getpid(),
                "mlockall": False,
            },
        }
