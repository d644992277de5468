"""Device memory probe.

Analog of the reference's ``checkMemory`` (cuda/hipMemGetInfo + device
properties printed at each lifecycle stage, ref: src/HypreSystem.cpp:638-671,
call sites src/main.cpp:175-177).  Uses ``device.memory_stats()`` where the
backend provides it (GPUs do; the CPU does not).
"""

from __future__ import annotations

import jax


def memory_report() -> str:
    lines = []
    for d in jax.devices():
        stats = None
        try:
            stats = d.memory_stats()
        except Exception:
            pass
        if not stats:
            lines.append(f"  {d}: memory stats unavailable")
            continue
        in_use = stats.get("bytes_in_use", 0)
        limit = stats.get("bytes_limit") or stats.get(
            "bytes_reservable_limit", 0)
        peak = stats.get("peak_bytes_in_use", 0)
        gib = 1 << 30
        lines.append(
            f"  {d}: in_use={in_use / gib:.2f}GiB peak={peak / gib:.2f}GiB"
            + (f" limit={limit / gib:.2f}GiB" if limit else ""))
    return "Device memory:\n" + "\n".join(lines)


def check_memory(verbose: bool = True) -> str:
    rep = memory_report()
    if verbose:
        print(rep, flush=True)
    return rep
