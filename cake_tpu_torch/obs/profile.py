"""A profiler trace around a region (counterpart of cake_tpu/obs/spans.py:
jax_trace): torch.profiler with CPU and, on a card, CUDA activities,
exported as one Chrome-trace JSON file (Perfetto or chrome://tracing
read it). It is the device-side complement of the span recorder's host
spans, and what SD's trace_dir (`cli serve --sd-trace-dir`) wraps a
generation in.

The profiler is process-wide: a trace taken on a server also holds what
other threads launch meanwhile (the chat engine's decode steps), and two
traces cannot be taken at once, so traced regions run one at a time
under a lock. Started from a job's worker thread, kineto may log `External
init callback must run in same thread as registerClient`; the trace is
written and parses all the same (19(b) of chip_smoke.py counts its
kernels).

`kernel_split` reads such a trace back: the device time of the kernels
launched inside a named `record_function` range (SD's `sd.unet_step`),
split by what launched them (SD's `sd.attention` range, convolutions,
matrix products, and the rest: elementwise work, casts, and the port's
norms, which are written as elementwise operators).
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

log = logging.getLogger("cake_tpu_torch.obs")

_TRACE_LOCK = threading.Lock()

# a kernel's class: the first of these whose names are open on its
# launching thread (a record_function range, then aten operators)
SPLIT = (("attention", ("sd.attention",)),
         ("conv", ("aten::convolution", "aten::conv2d",
                   "aten::cudnn_convolution")),
         ("gemm", ("aten::linear", "aten::addmm", "aten::mm",
                   "aten::matmul", "aten::bmm")))
LAUNCHES = ("cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def torch_trace(log_dir: str | None):
    """Profile the block into `log_dir`/trace_<pid>_<ns>.json, one traced
    block at a time in the process; does nothing when log_dir is None or
    empty."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with _TRACE_LOCK:
        with profile(activities=activities) as prof:
            yield
        path = os.path.join(log_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def kernel_split(events: list[dict], within: str) -> dict:
    """Device milliseconds of the kernels launched inside the ranges named
    `within`, by SPLIT's classes and `other`, with `total` and `ranges`
    (how many such ranges the trace holds). `events` is a Chrome trace's
    traceEvents as torch_trace writes them: a kernel is tied to its
    launch by `correlation`, the launch to the ranges and operators open
    on its thread at that moment."""
    by_thread: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in (
                "cpu_op", "user_annotation") + LAUNCHES:
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    open_at: dict = {}              # correlation -> names open, outer first
    ranges = 0
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: list = []
        for e in evs:
            while stack and stack[-1][0] <= e["ts"]:
                stack.pop()
            if e["cat"] in LAUNCHES:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    open_at[corr] = [name for _, name in stack]
                continue
            ranges += e["name"] == within
            stack.append((e["ts"] + e.get("dur", 0), e["name"]))
    out = {name: 0.0 for name, _ in SPLIT}
    out["other"] = 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        names = open_at.get((e.get("args") or {}).get("correlation"))
        if not names or within not in names:
            continue
        cls = next((c for c, keys in SPLIT
                    if any(name in keys for name in names)), "other")
        out[cls] += e.get("dur", 0) / 1e3
    out["total"] = sum(out.values())
    out["ranges"] = ranges
    return out
