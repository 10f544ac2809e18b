"""Timing shared by the port's bench entry points and chip_smoke.py."""
from __future__ import annotations

import statistics
import subprocess
import time

import torch


def time_ms(fn, device: torch.device = torch.device("cuda"), reps: int = 30,
            warmup: int = 3) -> float:
    """Median of ``reps`` timings of ``fn()`` in ms after ``warmup``
    calls: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sync(device: torch.device) -> None:
    """Wait for the card's queued work; nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def describe(device: torch.device) -> dict:
    """What ran and how it was timed, for a bench's JSON line."""
    if device.type == "cuda":
        return {"device": torch.cuda.get_device_name(device),
                "timer": "cuda_events", "nvidia_smi": nvidia_smi_line()}
    return {"device": "cpu", "timer": "host_clock"}


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (the first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
