"""Time on the card. Needs a CUDA card.

  * `device_ms`: device time per call, from CUDA events around calls the
    host queues while the card spins, so the card runs them back to back
    whatever the host's issue rate. Uses no profiler.
  * `wall_ms`: the host clock around back-to-back calls ending in a
    synchronize.
  * `issue_ms`: CUDA events around back-to-back calls with nothing
    queued ahead: the slower of the host issuing the calls and the card
    running them.
  * `kernel_times`: every kernel's duration from torch.profiler (CUPTI),
    for breakdowns by kernel. Where CUPTI tracing is not open to the
    process (another tool may hold it) it sees no kernel, so callers
    that must have device time use `device_ms`.
"""
from __future__ import annotations

import time

import torch

_SPIN_CYCLES = 1 << 20      # cycles of the calibration spin
_ms_per_cycle: float | None = None


def _spin_ms_per_cycle() -> float:
    """The card's time per cycle of `torch.cuda._sleep`, measured once."""
    global _ms_per_cycle
    if _ms_per_cycle is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SPIN_CYCLES)     # first launch: load the kernel
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(_SPIN_CYCLES)
        end.record()
        torch.cuda.synchronize()
        _ms_per_cycle = start.elapsed_time(end) / _SPIN_CYCLES
    return _ms_per_cycle


def device_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Device time per call of fn (warm L2): the card spins on one kernel
    for three times as long as `iters` calls took the host, the host
    queues the calls behind it, and CUDA events bracket the calls. The
    reading includes the card's gap between queued kernels, not the
    host's issue time. Raises if the host had not queued every call
    before the spin ended: that reading would be the issue rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    hold_ms = 3e3 * (time.perf_counter() - t0) + 1.0
    cycles = int(hold_ms / _spin_ms_per_cycle())
    spun, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    spun.record()
    torch.cuda._sleep(cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queued_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    spin_ms = spun.elapsed_time(start)
    if queued_ms >= spin_ms:
        raise RuntimeError(f"device_ms: the host took {queued_ms:.3f} ms to "
                           f"queue {iters} calls, longer than the "
                           f"{spin_ms:.3f} ms spin ahead of them")
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters: int, warmup: int = 2) -> float:
    """Host clock per call over back-to-back calls that end in a
    synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def issue_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """CUDA events around back-to-back calls, per call: the slower of the
    host issuing the calls and the device running them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(fn, iters: int, warmup: int = 3) -> list[tuple]:
    """(ms per call, launches per call, name) of every kernel that `iters`
    back-to-back calls of fn launched, longest first, from torch.profiler.
    Kernel events only: an aten op's own device time repeats the time of
    the kernels it launched. Empty where the profiler sees no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / iters / 1e3, ev.count / iters, ev.key))
    return sorted(rows, reverse=True)
