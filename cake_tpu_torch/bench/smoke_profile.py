"""Where `chip_smoke.py`'s time goes: run its `main` in this process with
Python's garbage collections timed by generation (`gc.callbacks`) and,
with --sample, a thread that samples every thread's stack every 4 ms.

    python -m cake_tpu_torch.bench.smoke_profile [--sample]
        [--out chiprun_out/smoke_profile.json] [-- chip_smoke args]

Run it from the checkout's root on a card. It prints the collections'
seconds and counts by generation after the script's own output and
writes them to --out, with the line that started each full collection,
a census of the tracked objects by type at the 100th full collection,
and the sampled seconds: inclusive seconds by
function and by line for the main thread, and for the other threads
while they were not waiting (a leaf frame outside threading, selectors,
socket, queue and subprocess). A collection holds the GIL, so the
sampler sees none of its time; the callbacks count it instead. The
sampler adds a few per cent to the run and drops every frame it read
before it sleeps, so that it keeps no caller's locals alive.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import sys
import threading
import time

INTERVAL_S = 0.004
IDLE = ("threading.py", "selectors.py", "socket.py", "queue.py",
        "socketserver.py", "subprocess.py")


class GcClock:
    """Seconds and count of the collections of each generation; the
    Python line that started each full (generation 2) collection; and,
    at the CENSUS_AT-th full collection, the tracked objects by type."""

    CENSUS_AT = 100

    def __init__(self):
        self.seconds = collections.Counter()
        self.count = collections.Counter()
        self.full_from = collections.Counter()
        self.census: dict = {}
        self._t0: dict[int, float] = {}

    def __call__(self, phase: str, info: dict) -> None:
        tid = threading.get_ident()
        if phase == "start":
            if info["generation"] == 2:
                f = sys._getframe(1)
                self.full_from[f"{os.path.basename(f.f_code.co_filename)}:"
                               f"{f.f_lineno}:{f.f_code.co_name}"] += 1
                del f
                if self.count[2] + 1 == self.CENSUS_AT:
                    self._take_census()
            self._t0[tid] = time.perf_counter()
            return
        t0 = self._t0.pop(tid, None)
        if t0 is not None:
            self.seconds[info["generation"]] += time.perf_counter() - t0
            self.count[info["generation"]] += 1

    def _take_census(self) -> None:
        objs = gc.get_objects()
        kinds = collections.Counter(type(o).__name__ for o in objs)
        self.census = {"tracked": len(objs),
                       "by_type": kinds.most_common(25)}
        del objs

    def summary(self) -> dict:
        return {"by_generation": {
                    str(g): {"seconds": round(self.seconds[g], 3),
                             "collections": self.count[g]}
                    for g in sorted(self.seconds)},
                "full_from": self.full_from.most_common(40),
                "census": self.census}


class Sampler:
    """Counts of the functions on every thread's stack, every INTERVAL_S."""

    def __init__(self, main_id: int):
        self.main_id = main_id
        self.main_incl = collections.Counter()
        self.main_leaf = collections.Counter()
        self.busy_incl = collections.Counter()
        self.busy_leaf = collections.Counter()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self) -> None:
        me = threading.get_ident()
        frames = sys._current_frames()
        for tid, frame in frames.items():
            if tid == me:
                continue
            code = frame.f_code
            name = os.path.basename(code.co_filename)
            leaf = f"{name}:{frame.f_lineno}:{code.co_name}"
            seen = set()
            f = frame
            while f is not None:
                seen.add(f"{os.path.basename(f.f_code.co_filename)}:"
                         f"{f.f_code.co_name}")
                f = f.f_back
            if tid == self.main_id:
                self.main_leaf[leaf] += 1
                self.main_incl.update(seen)
            elif name not in IDLE:
                self.busy_leaf[leaf] += 1
                self.busy_incl.update(seen)

    def _run(self) -> None:
        while not self.stop.is_set():
            time.sleep(INTERVAL_S)
            self._sample()

    def summary(self, top: int = 150) -> dict:
        def secs(c):
            return [(k, round(v * INTERVAL_S, 2)) for k, v in c.most_common(top)]
        return {"interval_s": INTERVAL_S,
                "main_inclusive": secs(self.main_incl),
                "main_leaf": secs(self.main_leaf),
                "busy_inclusive": secs(self.busy_incl),
                "busy_leaf": secs(self.busy_leaf)}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--out", default="chiprun_out/smoke_profile.json")
    ap.add_argument("smoke_args", nargs="*")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    clock = GcClock()
    gc.callbacks.append(clock)
    sampler = Sampler(threading.get_ident()) if args.sample else None
    if sampler is not None:
        sampler.thread.start()
    t0 = time.perf_counter()
    rc = 1
    try:
        rc = chip_smoke.main(args.smoke_args)
    finally:
        out = {"seconds": round(time.perf_counter() - t0, 1), "rc": rc,
               "gc": clock.summary()}
        if sampler is not None:
            sampler.stop.set()
            sampler.thread.join()
            out["sampled"] = sampler.summary()
        gc.callbacks.remove(clock)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=0)
        print(f"smoke_profile: gc by generation "
              f"{out['gc']['by_generation']}; "
              f"{out['seconds']} s; written to {args.out}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
