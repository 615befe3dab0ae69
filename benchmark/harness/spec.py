"""A cell found by name: its entry in ``BENCHMARK.json`` and its files.

A cell ``<name>`` is ``workloads/<name>.json`` (its configuration, how many
scans the check compares and the check's limits), the configuration
``configs/<config>.json`` (the model configuration as it is run, with its
weight scheme, the plain reference that judges it and the work module that
counts its FLOPs), the traffic mix ``traffic/<traffic>.json`` (the mode and
the generator's parameters) and, for each metric ``BENCHMARK.json`` gives the
cell, the reader ``metrics/<metric>.py``. Each is looked up in the search
directories in order, the benchmark's own folder last, so a cell, a
configuration or a metric is added by adding files.

A configuration names its reference, ``"reference": <module>``, a module
``reference/<module>.py`` that exports ``Reference(cfg, weights, device,
lowp=False)`` with ``.device``, ``.anchors`` (A, 7) and ``.forward(points)``
giving ``{'cls': (A, C), 'res', 'boxes', 'dir_labels'}``. It may name a work
module, ``"work": <module>``, ``work/<module>.py`` exporting
``batch_flops(cfg, scans)``: the dense FLOPs of one request's (B, N, 4)
scans. Without one, nothing reads the window's FLOPs. A configuration that
differs from another only in some top-level keys, such as its weight scheme,
names that one as ``"base"`` and gives only those keys: it is run as the
base configuration with them in place of the base's.
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


def load_module(kind, name, search):
    """The module ``<kind>/<name>.py`` of the search directories."""
    path = find(kind, name, '.py', search)
    spec = importlib.util.spec_from_file_location(
        f'bench_{kind}_' + name.replace('.', '_').replace('-', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_config(name, search):
    """Configuration ``name`` as it is run: its file, or, where the file
    names a ``"base"``, the base configuration with the file's top-level
    keys in place of the base's."""
    cfg = load_json('configs', name, search)
    base = cfg.pop('base', None)
    return {**load_config(base, search), **cfg} if base else cfg


def load_reader(name, search):
    """The ``read(rec)`` function of metric ``name``."""
    return load_module('metrics', name, search).read


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
        self.config = load_config(self.config_name, self.search)
        if 'reference' not in self.config:
            raise ValueError(f'configuration {self.config_name!r} names no reference: give it '
                             '"reference": the module under reference/ that judges it')
        nms = self.config['MODEL']['POST_PROCESSING']['NMS_CONFIG']
        if nms.get('MULTI_CLASSES_NMS', False):
            raise ValueError(f'configuration {self.config_name!r} sets MULTI_CLASSES_NMS; the '
                             'check judges the single NMS over the best class only')
        self.traffic = load_json('traffic', self.entry['traffic'], self.search)
        self.mode = self.traffic['mode']
        self.end_to_end = [m for m in bench['end_to_end'] if _applies(m, name)]
        self.per_layer = [m for m in bench['per_layer'] if _applies(m, name)]

    def reference(self, weights, device, lowp=False):
        """The configuration's plain reference with ``weights`` on ``device``."""
        module = load_module('reference', self.config['reference'], self.search)
        return module.Reference(self.config, weights, device, lowp=lowp)

    def work(self):
        """The configuration's work module, or None where it names none."""
        name = self.config.get('work')
        return load_module('work', name, self.search) if name else None

    def readers(self, trace):
        """[(metric entry, read function)] reported with ``--trace`` on or off."""
        metrics = self.per_layer if trace else self.end_to_end
        return [(m, load_reader(m['name'], self.search)) for m in metrics]
