"""Memory telemetry: host RSS + device memory, logged at stage boundaries
(the reference logs physical RSS via memory-stats, util.rs:52-72)."""

from __future__ import annotations

import logging

log = logging.getLogger("bronko")


def _host_rss_gb() -> float | None:
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        import os

        return pages * os.sysconf("SC_PAGE_SIZE") / 1e9
    except Exception:  # noqa: BLE001
        return None


def _device_mem_gb() -> float | None:
    try:
        import jax

        stats = jax.devices()[0].memory_stats()
        if stats and "bytes_in_use" in stats:
            return stats["bytes_in_use"] / 1e9
    except Exception:  # noqa: BLE001
        pass
    return None


def log_memory_usage(message: str, info: bool = True) -> None:
    host = _host_rss_gb()
    dev = _device_mem_gb()
    parts = []
    if host is not None:
        parts.append(f"host {host:.2f} GB")
    if dev is not None:
        parts.append(f"device {dev:.2f} GB")
    mem = ", ".join(parts) if parts else "unknown"
    (log.info if info else log.debug)("%s --- Memory usage: %s", message, mem)
