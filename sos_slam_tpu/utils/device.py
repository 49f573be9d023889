"""What the measurement entry points (`bench.py`, `chip_smoke.py`) require
of the device: a GPU, named by JAX and by nvidia-smi. Neither falls back to
the CPU: a number taken there is not a device number."""

from __future__ import annotations

import subprocess
import sys


def require_gpu(devices) -> None:
    """Exit with status 2 unless the first JAX device is a GPU."""
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"error: no GPU found (JAX default device is "
              f"{dev.platform}: {dev.device_kind}); refusing to run on it",
              file=sys.stderr, flush=True)
        raise SystemExit(2)


def gpu_identity() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
