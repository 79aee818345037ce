"""Finds a cell's parts by the names in BENCHMARK.json: its workload entry,
its configuration's file and plain reference, its traffic file, and the
readers of the metrics it reports. Adding a configuration, a traffic mix
or a metric is adding its file and its entry."""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Cell:
    """One workload of ``benchmark`` (the parsed BENCHMARK.json), whose
    files lie under ``root``."""

    def __init__(self, benchmark, name, root):
        self.root = root
        self.bench_dir = os.path.join(root, 'benchmark')
        by_name = {w['name']: w for w in benchmark['workloads']}
        if name not in by_name:
            raise KeyError('no workload {!r}; the benchmark has {}'.format(
                name, ', '.join(sorted(by_name))))
        self.workload = by_name[name]
        self.name = name
        configs = {c['name']: c for c in benchmark['configs']}
        self.config_entry = configs[self.workload['config']]
        with open(os.path.join(root, self.config_entry['file'])) as f:
            self.config = json.load(f)
        with open(os.path.join(self.bench_dir, 'traffic',
                               self.workload['traffic'] + '.json')) as f:
            self.traffic = json.load(f)
        self.end_to_end = [m for m in benchmark['end_to_end']
                           if name in m.get('workloads', [name])]
        reported = {m['name'] for m in self.end_to_end}
        self.per_layer = [m for m in benchmark['per_layer']
                          if (name in m['workloads'] if 'workloads' in m
                              else m['moves'] in reported)]

    def reference(self):
        """The configuration's plain reference module (``forward``,
        ``anchors``, ``label_columns``), from the file its configuration
        names beside the configuration's own."""
        directory = os.path.dirname(os.path.join(self.root,
                                                 self.config_entry['file']))
        return load_module(os.path.join(
            directory, self.config['reference'] + '.py'))

    def reader(self, metric):
        """The reader of ``metric`` (its ``read(record)``)."""
        return load_module(os.path.join(self.bench_dir, 'metrics',
                                        metric + '.py')).read


def load_module(path):
    name = 'bench_' + os.path.relpath(path, BENCH_DIR).replace(
        os.sep, '_').replace('.', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load(root):
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)
