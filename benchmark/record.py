"""What one run leaves for the metric readers (benchmark/metrics/*.py):
each reader's read(run) takes a RunRecord and returns a number, or None
where it finds nothing to read."""
from dataclasses import dataclass, field


@dataclass
class RunRecord:
    config: dict
    mix: dict
    seed: int
    setup_s: float
    window_s: float = 0.0
    cpu_s: float = 0.0          # user + system CPU of the process, window
    requests: list = field(default_factory=list)   # client.RequestRecord
    stats: dict = field(default_factory=dict)      # route counters
    trace: object = None        # trace.TraceSummary of the traced stretch
    rooflines: list = field(default_factory=list)  # benchmark/roofline mods
    peaks: dict = field(default_factory=dict)

    @property
    def pictures(self):
        """Every picture returned in the window."""
        return [p for r in self.requests for p in r.returned]

    def unprofiled(self):
        """The requests outside the profiled stretch (their spans carry
        no profiler overhead)."""
        return [r for r in self.requests if not r.profiled]

    def profiled(self):
        return [r for r in self.requests if r.profiled]
