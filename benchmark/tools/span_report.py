"""One traced run of a cell with the program's spans laid over the card's
trace, reported as one JSON object:

    python3 -m benchmark.tools.span_report --workload NAME --seed N \\
        --seconds S [--out PATH]

from the root of a checkout on the card (it runs as ``benchmark.run
--trace 1`` does and exits 2 without the cell's devices). The report holds
the run's per-layer metrics and, over the traced slice:

- ``dispatch`` and ``resolve``: each one's mean a batch, its children's
  self times a batch (a span's time less its own children's), its own
  time outside its children, and how much of it the children cover;
- ``idle_by_span``: the share of the card's idle time under each span,
  each idle instant named by the innermost program span that covers it,
  else the harness's innermost ``bench.*`` span, else ``other``;
- ``longest_gaps``: the ten longest idle gaps, each named by the span
  that covers most of it, with that span's share of the gap;
- ``harness_less_program_ms``: on each batch, the harness's
  ``bench.dispatch`` less the program's ``backend.dispatch`` within it;
- ``dispatch_ms``: the harness's mean dispatch a batch, frames a batch
  and largest bucket, in the window before the slice and in the slice
  (the cost of the profiler on, and whether the slice ran another
  bucket);
- ``span_cost_us``: one span's enter and exit with no capture running,
  with one running, and a bare ``record_function`` with one running.

A program without the recorder reports only the metrics and the cost of
a bare ``record_function``.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import run as bench_run  # noqa: E402
from benchmark.lib import spans as program_spans  # noqa: E402
from benchmark.lib import stats  # noqa: E402

DISPATCH = 'backend.dispatch'
RESOLVE = 'backend.resolve'
TOP = 10
COST_CALLS = 20000


def parse(argv=None):
    parser = argparse.ArgumentParser(
        prog='python3 -m benchmark.tools.span_report',
        description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--out', help='also write the report here')
    return parser.parse_args(argv)


def self_times(found, name):
    """(mean ms a batch of the spans ``name``, {child: mean self ms a
    batch}, own ms a batch, [each span's children's cover, %]) over the
    spans ``name`` in ``found``, or None where there are none."""
    tops = [s for s in found if s.name == name]
    if not tops:
        return None
    children = {}
    for s in found:
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
    top_ids = {s.id for s in tops}
    by_name, covers, own = {}, [], 0

    def duration(s):
        return s.end_ns - s.start_ns

    for top in tops:
        kids = children.get(top.id, [])
        inside = sum(duration(k) for k in kids)
        own += duration(top) - inside
        if duration(top):
            covers.append(100.0 * inside / duration(top))
    for s in found:
        if s.parent in top_ids:
            inner = sum(duration(k) for k in children.get(s.id, []))
            by_name[s.name] = by_name.get(s.name, 0) + duration(s) - inner
    n = len(tops)
    return (sum(duration(s) for s in tops) / n / 1e6,
            {k: v / n / 1e6 for k, v in sorted(by_name.items())},
            own / n / 1e6, covers)


def phase(found, name):
    got = self_times(found, name)
    if got is None:
        return None
    mean, children, own, covers = got
    return {'batches': len(covers), 'mean_ms': mean,
            'children_self_ms': children, 'own_ms': own,
            'cover_min_pct': min(covers) if covers else None,
            'cover_mean_pct': sum(covers) / len(covers) if covers else None}


def innermost(program, harness):
    """Sorted disjoint (start, end, name) segments, each named by the
    innermost program span over it (the latest to start among those that
    cover it), else the harness's innermost span."""
    spans = [(s, e, 1, name) for s, e, name in program] + \
            [(s, e, 0, name) for s, e, name in harness]
    bounds = sorted({t for s, e, *_ in spans for t in (s, e)})
    opening = sorted(spans)
    active, out, k = [], [], 0
    for left, right in zip(bounds, bounds[1:]):
        while k < len(opening) and opening[k][0] <= left:
            active.append(opening[k])
            k += 1
        active = [a for a in active if a[1] > left]
        if not active:
            continue
        name = max(active, key=lambda a: (a[2], a[0]))[3]
        if out and out[-1][1] == left and out[-1][2] == name:
            out[-1] = (out[-1][0], right, name)
        else:
            out.append((left, right, name))
    return out


def name_gaps(gaps, segments):
    """For each (start, end) gap, {name: ns of it under that name}, the
    time under no segment named 'other'."""
    starts = [s for s, _, _ in segments]
    named = []
    for gs, ge in gaps:
        cover = {}
        i = max(bisect.bisect_right(starts, gs) - 1, 0)
        while i < len(segments) and segments[i][0] < ge:
            s, e, name = segments[i]
            overlap = min(e, ge) - max(s, gs)
            if overlap > 0:
                cover[name] = cover.get(name, 0) + overlap
            i += 1
        rest = (ge - gs) - sum(cover.values())
        if rest > 0:
            cover['other'] = cover.get('other', 0) + rest
        named.append(cover)
    return named


def idle(trace, found):
    """(idle share by span, the ten longest gaps) of the slice, or
    (None, None) without device events."""
    if not trace['device']:
        return None, None
    gaps = stats.gaps(trace['device'], *trace['window_ns'])
    program = [(s.start_ns, s.end_ns, s.name) for s in found]
    harness = [(s, e, 'bench.' + name) for s, e, name in trace['host']]
    named = name_gaps(gaps, innermost(program, harness))
    total = sum(e - s for s, e in gaps)
    by_name = {}
    for cover in named:
        for name, ns in cover.items():
            by_name[name] = by_name.get(name, 0) + ns
    shares = {k: 100.0 * v / total for k, v in
              sorted(by_name.items(), key=lambda kv: -kv[1])} \
        if total else {}
    longest = sorted(range(len(gaps)),
                     key=lambda i: gaps[i][0] - gaps[i][1])[:TOP]
    top = []
    for i in longest:
        s, e = gaps[i]
        name, ns = max(named[i].items(), key=lambda kv: kv[1])
        top.append({'ms': (e - s) / 1e6, 'name': name,
                    'share_pct': 100.0 * ns / (e - s)})
    return shares, top


def harness_less_program(trace, found):
    """On each harness dispatch, the harness's time less that of the
    program dispatch it overlaps most (ms), where that overlap is more
    than half the program's span: the two clocks' stamps may differ by
    a little, so a span is not required to lie wholly inside the other."""
    program = sorted((s.start_ns, s.end_ns) for s in found
                     if s.name == DISPATCH)
    starts = [s for s, _ in program]
    out = []
    for hs, he, name in sorted(trace['host']):
        if name != 'dispatch':
            continue
        i = bisect.bisect_left(starts, hs)
        near = program[max(i - 1, 0):i + 2]
        if not near:
            continue
        ps, pe = max(near, key=lambda p: min(he, p[1]) - max(hs, p[0]))
        if 2 * (min(he, pe) - max(hs, ps)) > pe - ps:
            out.append(((he - hs) - (pe - ps)) / 1e6)
    return out


def dispatch_ms(rec):
    """The harness's mean dispatch a batch (ms, its host clock), mean
    frames a batch and largest bucket, before the traced slice and in
    it."""
    batches = rec['batches']
    start, end = rec['window']
    cut = rec['cut']
    out = {}
    for key, lo, hi in (('before_slice', start, cut), ('in_slice', cut, end)):
        keep = (batches['dispatch0'] >= lo) & (batches['dispatch1'] <= hi)
        took = batches['dispatch1'][keep] - batches['dispatch0'][keep]
        out[key] = float(took.mean() * 1e3) if len(took) else None
        out[key + '_batches'] = int(keep.sum())
        if len(took):
            out[key + '_frames'] = float(batches['frames'][keep].mean())
            out[key + '_bucket_max'] = int(batches['bucket'][keep].max())
    return out


def span_cost(calls=COST_CALLS):
    """us a call: a span's enter and exit with one count, with no capture
    and under one; a bare record_function under one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        from watsor_tpu_torch.runtime import spans
    except ImportError:
        spans = None
    clock = time.perf_counter_ns
    out = {}

    def each(make):
        t0 = clock()
        for _ in range(calls):
            with make():
                pass
        return (clock() - t0) / calls / 1e3

    if spans is not None:
        out['off'] = each(lambda: spans.span('span_report.cost', rows=1))
    with profile(activities=[ProfilerActivity.CPU]):
        if spans is not None:
            out['on'] = each(lambda: spans.span('span_report.cost', rows=1))
        out['record_function_on'] = each(
            lambda: torch.autograd.profiler.record_function(
                'span_report.cost'))
    if spans is not None:
        spans.clear()
    return out


def report(rec):
    """The report of a traced run's record (without the cost)."""
    trace = rec['trace']
    if trace is None:
        return None
    found = program_spans.window(rec) or []
    shares, top = idle(trace, found)
    diffs = harness_less_program(trace, found)
    return {'program_spans': len(found),
            'dispatch': phase(found, DISPATCH),
            'resolve': phase(found, RESOLVE),
            'idle_by_span': shares, 'longest_gaps': top,
            'harness_less_program_ms': {
                'batches': len(diffs),
                'min': min(diffs) if diffs else None,
                'max': max(diffs) if diffs else None},
            'dispatch_ms': dispatch_ms(rec)}


def main(argv=None):
    args = parse(argv)
    bench_run.environment(bench_run.ROOT)
    from benchmark.lib import spec
    cell = spec.Cell(spec.load(bench_run.ROOT), args.workload,
                     bench_run.ROOT)
    import torch
    chips = cell.workload['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print('span_report: the cell needs {} CUDA device(s)'.format(chips),
              file=sys.stderr)
        return 2
    from benchmark.lib import cell as runner
    device = torch.device('cuda', 0)
    result, _, rec = runner.run(cell, args.seed, args.seconds, True, device,
                                STARTED)
    out = {'workload': args.workload, 'seed': args.seed,
           'card': torch.cuda.get_device_name(device),
           'correct': result['correct'], 'metrics': result['metrics'],
           'device': result['device'], 'breakdown': result.get('breakdown'),
           'spans': report(rec), 'span_cost_us': span_cost()}
    text = json.dumps(out)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(text + '\n')
    print(text, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
