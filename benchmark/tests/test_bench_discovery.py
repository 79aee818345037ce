"""The harness finds a cell's configuration, reference, traffic and metric
readers by the names in BENCHMARK.json, so that a later change adds a
configuration, a cell or a metric with new files and entries alone: shown
in a temporary copy, whose added cell then runs on the CPU and reports
the added metric."""

import json
import os

from benchmark.lib import spec
from benchmark.tests.cpu import copy_benchmark, run_cpu, tiny, write_json


def test_every_named_part_is_found():
    root = os.path.dirname(spec.BENCH_DIR)
    bench = spec.load(root)
    for workload in bench['workloads']:
        cell = spec.Cell(bench, workload['name'], root)
        assert cell.reference().forward
        assert {m['name'] for m in cell.end_to_end} >= {'setup_s'}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for metric in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(metric['name']))
        moved = {m['moves'] for m in cell.per_layer}
        assert moved <= {m['name'] for m in cell.end_to_end}


def test_an_addition_needs_only_new_files_and_entries(tmp_path):
    root = copy_benchmark(tmp_path)
    before = {}
    for directory, _, files in os.walk(root):
        for name in files:
            path = os.path.join(directory, name)
            with open(path, 'rb') as f:
                before[path] = f.read()

    bench_dir = os.path.join(root, 'benchmark')
    with open(os.path.join(bench_dir, 'configs',
                           'efficientdet_lite4.json')) as f:
        cfg = json.load(f)
    write_json(os.path.join(bench_dir, 'configs', 'lite4_small.json'), cfg)
    with open(os.path.join(bench_dir, 'traffic', 'lite4.sat64.json')) as f:
        traffic = json.load(f)
    write_json(os.path.join(bench_dir, 'traffic', 'small.sat8.json'),
               traffic)
    with open(os.path.join(bench_dir, 'metrics', 'frames_a_batch.sat.py'),
              'w') as f:
        f.write('from benchmark.lib import records\n\n\n'
                'def read(rec):\n'
                '    return records.mean(records.batches(rec)["frames"])\n')

    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    bench['configs'].append({
        'name': 'lite4_small', 'source': cfg['source'],
        'file': 'benchmark/configs/lite4_small.json',
        'reduced': [], 'why': 'a test configuration'})
    bench['workloads'].append({
        'name': 'small.sat8', 'config': 'lite4_small',
        'traffic': 'small.sat8', 'chips': 1, 'why': 'a test cell'})
    for entry in bench['end_to_end']:
        if entry['name'] == 'detect_fps':
            entry['workloads'].append('small.sat8')
    bench['per_layer'].append({
        'name': 'frames_a_batch.sat', 'unit': 'frames', 'better': 'higher',
        'source': 'program_counter', 'layer': 'backend',
        'moves': 'detect_fps', 'workloads': ['small.sat8']})
    write_json(os.path.join(root, 'BENCHMARK.json'), bench)

    cell = tiny(spec.Cell(spec.load(root), 'small.sat8', root),
                cameras=8)
    assert cell.config['model'] == 'efficientdet_lite4'
    result, _, _ = run_cpu(cell, traced=True)
    assert result['correct'], result['compared']
    assert result['metrics']['frames_a_batch.sat']['value'] == 8.0

    for path, content in before.items():
        if path.endswith('BENCHMARK.json'):
            continue
        with open(path, 'rb') as f:
            assert f.read() == content, path
