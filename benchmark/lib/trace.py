"""The traced run's profile: torch.profiler (CUPTI on the card) over a
steady slice at the end of the window, with the harness's own host spans
(``bench.stage``, ``bench.dispatch``, ``bench.resolve``, ``bench.wait``,
``bench.keep``) as user annotations. Nothing is written to disk: the
events are read in memory when the slice ends and reduced to the spans the
metric readers need."""

import contextlib

import torch

from benchmark.lib import stats

SLICE = 'bench.slice'


class Slice:
    """Profiles the last ``seconds`` of the window, or nothing when
    ``seconds`` is None. ``arm`` places it once the window has started,
    ``tick(now)`` starts it, ``finish()`` stops it at the window's close."""

    def __init__(self, seconds=None, device=None):
        self.seconds = seconds
        self.device = device
        self.start = None
        self.state = 'idle'
        self.prof = None
        self.mark = None
        self.events = None

    def arm(self, window_start, window_seconds):
        if self.seconds:
            self.start = window_start + window_seconds - self.seconds

    @property
    def active(self):
        return self.state == 'on'

    def tick(self, now):
        if self.state != 'idle' or self.start is None or now < self.start:
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.device(self.device).type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.mark = torch.autograd.profiler.record_function(SLICE)
        self.mark.__enter__()
        self.state = 'on'

    def span(self, name):
        """A host span of the harness, recorded while the slice runs."""
        if self.state == 'on':
            return torch.autograd.profiler.record_function(name)
        return contextlib.nullcontext()

    def finish(self):
        """Stop at the window's close: wait for the device's work, end the
        slice's span, read the events."""
        if self.state != 'on':
            return
        if torch.device(self.device).type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.events = self.prof.profiler.kineto_results.events()
        self.prof = None
        self.state = 'done'

    def reduce(self):
        """{'window_ns': (start, end), 'device': [(start, end, name)],
        'host': [(start, end, name)]} within the slice, or None."""
        if self.events is None:
            return None
        window = None
        device, host = [], []
        for e in self.events:
            kind = e.device_type().name
            if kind == 'CUDA' and not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns(), e.name()))
            elif kind == 'CPU' and e.is_user_annotation():
                if e.name() == SLICE:
                    window = (e.start_ns(), e.end_ns())
                elif e.name().startswith('bench.'):
                    host.append((e.start_ns(), e.end_ns(),
                                 e.name()[len('bench.'):]))
        if window is None:
            return None
        return {'window_ns': window,
                'device': stats.clip(device, *window),
                'host': stats.clip(host, *window)}


def breakdown(trace, top=10):
    """The device operations with the most time in the slice and its
    longest idle gaps, each named by the harness's host span that covers
    most of it ('other' where none does): [[name, seconds], ...]."""
    totals = {}
    for s, e, name in trace['device']:
        totals[name] = totals.get(name, 0.0) + (e - s) / 1e9
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    idle = []
    longest = sorted(stats.gaps(trace['device'], *trace['window_ns']),
                     key=lambda g: g[0] - g[1])[:top]
    for s, e in longest:
        cover = {}
        for hs, he, name in trace['host']:
            overlap = min(e, he) - max(s, hs)
            if overlap > 0:
                cover[name] = cover.get(name, 0) + overlap
        name = max(cover, key=cover.get) if cover else 'other'
        idle.append([name, (e - s) / 1e9])
    return {'device_ops': [[n, v] for n, v in ops], 'idle_gaps': idle}
