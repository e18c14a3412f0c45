"""`cli top` — live fleet dashboard over GET /api/v1/fleet/telemetry (the
port's own copy of cake_tpu/fleet/top.py: the same renders, line for
line, but for a window with no TTFT observation, where the reference's
raises and the port's prints dashes).

Renders the router's telemetry rollup (fleet/telemetry.py) as a
terminal dashboard: a fleet header (SLO burn rates, capacity headroom,
sheds/s, merged percentiles) over one row per replica (state, queue
depth, occupancy, TTFT p95, error rate, tok/s, speculative accept
rate, headroom, stale/outlier flags). Interactive mode is curses
(q quits, refreshes every --interval); `--once` / `--plain` / a
non-tty stdout fall back to plain text so the same command works in a
pipe or a cron job. Rendering is pure text-from-dict (render_screen),
so tests drive it with canned bodies and never need a terminal.
"""
from __future__ import annotations

import json
import sys
import time
import urllib.error
import urllib.request

TELEMETRY_PATH = "/api/v1/fleet/telemetry"


def fetch_telemetry(base_url: str, timeout_s: float = 3.0) -> dict:
    """One GET of the router's telemetry snapshot. Raises OSError (or a
    urllib subclass of it) when the router is unreachable."""
    url = base_url.rstrip("/") + TELEMETRY_PATH
    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return json.loads(r.read().decode("utf-8", "replace"))


def _fmt(v, spec: str = ".1f", dash: str = "-") -> str:
    """Format a maybe-None number; telemetry rows use None for 'no
    window data yet', which renders as a dash rather than 0 (a real
    zero is information; absence is not)."""
    if v is None:
        return dash
    return format(v, spec)


def _ms(seconds) -> str:
    return "-" if seconds is None else f"{seconds * 1000:.0f}ms"


def _pct(v) -> str:
    return "-" if v is None else f"{v * 100.0:.0f}%"


def render_screen(body: dict, base_url: str = "",
                  width: int = 100) -> list[str]:
    """The dashboard as a list of lines (curses and plain mode both
    draw exactly these)."""
    burn = body.get("burn_rate", {})
    pct = body.get("percentiles", {})
    ttft = pct.get("ttft", {})
    lines = [
        f"cake top — {base_url or 'fleet'}   cycle {body.get('cycles', 0)}"
        f"   slo ttft {body.get('slo', {}).get('ttft_ms', 0):.0f}ms"
        f" err {body.get('slo', {}).get('err_rate', 0):.2%}",
        f"burn fast {burn.get('fast', 0.0):.2f}x"
        f"  slow {burn.get('slow', 0.0):.2f}x"
        f"   headroom {body.get('headroom_tokens_per_s', 0.0):.0f} tok/s"
        f"   sheds {body.get('sheds_per_s', 0.0):.2f}/s"
        f"   queue {body.get('fleet_queue_depth', 0)}",
    ]
    if ttft:
        # a window whose histograms hold no observation has None
        # percentiles (the reference's render raises there)
        lines.append(
            f"fleet ttft p50 {_ms(ttft.get('p50', 0))}"
            f"  p95 {_ms(ttft.get('p95', 0))}"
            f"  p99 {_ms(ttft.get('p99', 0))}"
            f"  (n={ttft.get('count', 0):.0f}, fast window)")
    else:
        lines.append("fleet ttft percentiles: no window data yet")
    scale = body.get("autoscale")
    if scale:
        last = scale.get("last") or {}
        if last:
            age = last.get("age_s")
            what = f"last {last.get('kind', '?')}"
            if last.get("reason"):
                what += f"({last['reason']})"
            if last.get("replica"):
                what += f" {last['replica']}"
            if age is not None:
                what += f" {age:.0f}s ago"
        else:
            what = "no decisions yet"
        lines.append(
            f"autoscale [{scale.get('min', '?')}"
            f"..{scale.get('max', '?')}]"
            f"   managed {scale.get('managed', 0)}"
            f"   pending {scale.get('pending_spawns', 0)}"
            f"   {what}")
    lines.append("")
    hdr = (f"{'REPLICA':<14} {'STATE':<9} {'DEPTH':>5} {'OCC':>5} "
           f"{'INFL':>5} {'TTFTp95':>8} {'ERR':>6} {'TOK/S':>8} "
           f"{'ACC':>5} {'HDRM':>7}  FLAGS")
    lines.append(hdr[:width])
    replicas = body.get("replicas", {})
    for name in sorted(replicas):
        row = replicas[name]
        flags = []
        if row.get("stale"):
            flags.append("stale")
        if row.get("partition_s") is not None:
            flags.append(f"partition({row['partition_s']:.0f}s)")
        if row.get("outlier"):
            reason = row.get("outlier_reason")
            flags.append(f"outlier({reason})" if reason
                         and reason != "stale" else "outlier")
        line = (f"{name[:14]:<14} {str(row.get('state', '?'))[:9]:<9} "
                f"{row.get('queue_depth', 0):>5} "
                f"{_pct(row.get('occupancy')):>5} "
                f"{row.get('inflight', 0):>5} "
                f"{_fmt(row.get('ttft_p95_ms'), '.0f'):>8} "
                f"{_pct(row.get('err_rate')):>6} "
                f"{_fmt(row.get('tokens_per_s'), '.1f'):>8} "
                f"{_pct(row.get('accept_rate')):>5} "
                f"{_fmt(row.get('headroom_tokens_per_s'), '.0f'):>7}  "
                f"{' '.join(flags)}")
        lines.append(line[:width])
    if not replicas:
        lines.append("(no replicas registered yet)")
    return lines


def _plain_once(base_url: str, timeout_s: float) -> int:
    try:
        body = fetch_telemetry(base_url, timeout_s)
    except OSError as e:
        print(f"cake top: {base_url}{TELEMETRY_PATH}: {e}",
              file=sys.stderr)
        return 1
    for line in render_screen(body, base_url):
        print(line)
    return 0


def _curses_loop(base_url: str, interval_s: float,
                 timeout_s: float) -> int:
    import curses

    def loop(scr):
        curses.curs_set(0)
        scr.timeout(int(interval_s * 1000))
        err = None
        body = {}
        while True:
            try:
                body = fetch_telemetry(base_url, timeout_s)
                err = None
            except OSError as e:
                err = str(e)
            h, w = scr.getmaxyx()
            scr.erase()
            lines = render_screen(body, base_url, width=w - 1)
            if err:
                lines.insert(0, f"[unreachable: {err}]"[:w - 1])
            for y, line in enumerate(lines[:h - 1]):
                scr.addstr(y, 0, line)
            scr.addstr(h - 1, 0, "q to quit"[:w - 1])
            scr.refresh()
            ch = scr.getch()      # doubles as the refresh sleep
            if ch in (ord("q"), ord("Q")):
                return 0

    return curses.wrapper(loop)


def run_top(base_url: str, interval_s: float = 2.0, once: bool = False,
            plain: bool = False, timeout_s: float = 3.0) -> int:
    """CLI entry. Curses when interactive; plain text when --once,
    --plain, or stdout is not a tty (pipes, CI)."""
    if once:
        return _plain_once(base_url, timeout_s)
    try:
        if plain or not sys.stdout.isatty():
            while True:
                rc = _plain_once(base_url, timeout_s)
                if rc != 0:
                    return rc
                print()
                time.sleep(interval_s)
        return _curses_loop(base_url, interval_s, timeout_s)
    except KeyboardInterrupt:
        return 0
