"""Profiling HTTP endpoint (reference pkg/pprof/listener.go:18-44).

Python-runtime equivalents of the Go pprof handlers:

    /debug/pprof/threads   — all thread stacks (goroutine-profile analogue)
    /debug/pprof/profile   — cProfile sample for ?seconds=N, pstats text
    /debug/pprof/heap      — per-type object counts + gc stats
    /debug/pprof/trace     — the request-trace ring buffer as text
                             (span trees per trace; see docs/observability.md)

Concurrent /debug/pprof/profile requests are serialized behind one lock:
two overlapping cProfile sessions race the interpreter's global profiler
hook, and the second would silently corrupt (or steal) the first's
sample. Serialized, each requester gets a full, clean window.

Gated by the system-controller config exactly like the reference
(snapshot.go:254-261).
"""

from __future__ import annotations

import cProfile
import gc
import io
import pstats
import sys
import threading
import traceback
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit


def _thread_dump() -> str:
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append(f"thread {ident} [{names.get(ident, '?')}]:")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


def _heap_dump(limit: int = 50) -> str:
    counts = Counter(type(o).__name__ for o in gc.get_objects())
    lines = [f"{n} {c}" for n, c in counts.most_common(limit)]
    lines.append("")
    lines.append(f"gc_counts {gc.get_count()}")
    return "\n".join(lines)


_profile_lock = threading.Lock()


def _cpu_profile(seconds: float) -> str:
    with _profile_lock:
        prof = cProfile.Profile()
        done = threading.Event()
        prof.enable()
        done.wait(seconds)
        prof.disable()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(60)
    return buf.getvalue()


def new_pprof_http_listener(addr: str) -> ThreadingHTTPServer:
    """Start the profiling server on ``host:port``; returns it (caller owns
    shutdown)."""
    if not addr:
        raise ValueError("the address for pprof HTTP server is invalid")
    host, _, port = addr.rpartition(":")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            parsed = urlsplit(self.path)
            if parsed.path in ("/debug/pprof/threads", "/debug/pprof/goroutine"):
                body = _thread_dump()
            elif parsed.path == "/debug/pprof/heap":
                body = _heap_dump()
            elif parsed.path == "/debug/pprof/profile":
                secs = float(parse_qs(parsed.query).get("seconds", ["1"])[0])
                body = _cpu_profile(min(secs, 60.0))
            elif parsed.path == "/debug/pprof/trace":
                from nydus_snapshotter_tpu_torch import trace

                body = trace.dump_text()
            else:
                self.send_response(404)
                self.end_headers()
                return
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = ThreadingHTTPServer((host or "127.0.0.1", int(port)), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
