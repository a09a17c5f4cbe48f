"""The traced run's device trace: ``torch.profiler`` (CUPTI) over the whole
window, reduced to device intervals, with the host ranges the driver times.
"""

from __future__ import annotations

from dataclasses import dataclass, field

WINDOW_LABEL = "bench.window"


@dataclass
class Interval:
    name: str
    start: float  # seconds, profiler time
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class DeviceTrace:
    device: list[Interval] = field(default_factory=list)  # kernels, copies, sets
    host: list[Interval] = field(default_factory=list)  # the driver's ranges
    window: Interval | None = None

    @staticmethod
    def short(name: str) -> str:
        """A device event's name without return type, anonymous namespace,
        template or argument list: ``void ns::(anonymous namespace)::k<T>(
        int)`` -> ``ns::k``."""
        name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
        for stop in "(<":
            name = name.split(stop, 1)[0]
        return name.strip()

    @classmethod
    def ident(cls, name: str) -> str:
        """A kernel's function name alone: ``ns::k<T>(int)`` -> ``k``."""
        return cls.short(name).rsplit("::", 1)[-1]

    def seconds_of(self, idents) -> float | None:
        """Device seconds of the events named ``idents``; None if none ran."""
        hits = [e.seconds for e in self.device if self.ident(e.name) in idents]
        return sum(hits) if hits else None

    def copies(self, direction: str) -> list[Interval]:
        """Copy events of one direction (``HtoD``, ``DtoH``, ``DtoD``)."""
        return [e for e in self.device if e.name.startswith("Memcpy") and direction in e.name]

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device intervals, in order."""
        out: list[list[float]] = []
        for e in sorted(self.device, key=lambda e: e.start):
            if out and e.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e.end)
            else:
                out.append([e.start, e.end])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self) -> list[tuple[float, float]]:
        """Idle intervals of the device inside the window."""
        if self.window is None:
            return []
        edge, out = self.window.start, []
        for a, b in self.busy():
            if a > edge:
                out.append((edge, min(a, self.window.end)))
            edge = max(edge, b)
        if self.window.end > edge:
            out.append((edge, self.window.end))
        return [(a, b) for a, b in out if b > a]

    def host_at(self, t: float) -> str:
        """The driver's ranges open at time ``t``, by name."""
        names = sorted({h.name for h in self.host if h.start <= t < h.end})
        return "+".join(names) if names else "host_other"

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for e in self.device:
            key = self.short(e.name)[:80]
            by_name[key] = by_name.get(key, 0.0) + e.seconds
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_at((a + b) / 2), b - a] for a, b in gaps]}


def collect(prof, host: list, window_t0: float) -> DeviceTrace:
    """Device events of a finished profile, and the driver's host ranges
    (label, start, end in perf_counter seconds; ``window_t0`` is the
    perf_counter reading as the window's profiler range opened)."""
    from torch.autograd import DeviceType

    tr = DeviceTrace()
    for e in prof.events():
        iv = Interval(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type == DeviceType.CUDA:
            # CUPTI's own buffer bookkeeping shows as a device event too
            if "Activity Buffer" not in e.name:
                tr.device.append(iv)
        elif e.name == WINDOW_LABEL:
            tr.window = iv
    shift = tr.window.start - window_t0 if tr.window is not None else 0.0
    tr.host = [Interval(label, a + shift, b + shift) for label, a, b in host]
    return tr
