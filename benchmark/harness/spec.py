"""A cell found by name: its entry in ``BENCHMARK.json`` and its files.

A cell ``<name>`` is ``workloads/<name>.json`` (its configuration, traffic
mix, class bias and how many scans the check compares), the configuration
``configs/<config>.json`` (the model configuration as it is run, with its
weight scheme), the traffic mix ``traffic/<traffic>.json`` (the mode and the
generator's parameters) and, for each metric ``BENCHMARK.json`` gives the
cell, the reader ``metrics/<metric>.py``. Each is looked up in the search
directories in order, the benchmark's own folder last, so a cell, a
configuration or a metric is added by adding files.
"""

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = BENCH_DIR.parent


def find(kind, name, ext, search):
    for root in search:
        path = Path(root) / kind / f'{name}{ext}'
        if path.exists():
            return path
    raise FileNotFoundError(f'no {kind}/{name}{ext} under {[str(s) for s in search]}')


def load_json(kind, name, search):
    return json.loads(find(kind, name, '.json', search).read_text())


def load_reader(name, search):
    """The ``read(rec)`` function of metric ``name``."""
    path = find('metrics', name, '.py', search)
    spec = importlib.util.spec_from_file_location(
        'bench_metric_' + name.replace('.', '_').replace('-', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(metric, cell):
    return 'workloads' not in metric or cell in metric['workloads']


class Cell:
    """Everything one run of a cell reads, found by the cell's name."""

    def __init__(self, name, bench_json=None, search=None):
        self.search = [*(search or []), BENCH_DIR]
        bench = json.loads(Path(bench_json or REPO_ROOT / 'BENCHMARK.json').read_text())
        entries = {w['name']: w for w in bench['workloads']}
        if name not in entries:
            raise KeyError(f'cell {name!r} is not in BENCHMARK.json ({sorted(entries)})')
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry['chips'])
        self.file = load_json('workloads', name, self.search)
        self.config_name = self.entry['config']
        self.config = load_json('configs', self.config_name, self.search)
        self.traffic = load_json('traffic', self.entry['traffic'], self.search)
        self.mode = self.traffic['mode']
        self.end_to_end = [m for m in bench['end_to_end'] if _applies(m, name)]
        self.per_layer = [m for m in bench['per_layer'] if _applies(m, name)]

    def readers(self, trace):
        """[(metric entry, read function)] reported with ``--trace`` on or off."""
        metrics = self.per_layer if trace else self.end_to_end
        return [(m, load_reader(m['name'], self.search)) for m in metrics]
