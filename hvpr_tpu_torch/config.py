"""YAML configs with ``_BASE_CONFIG_`` inheritance and attribute access.

The port's own copy of ``hvpr_tpu/config.py`` (``ConfigDict``,
``merge_new_config``, ``cfg_from_yaml_file``): it reads the same files under
``tools/cfgs/`` and yields the same nested dicts.
"""

import yaml


class ConfigDict(dict):
    """dict subclass with attribute access, recursively converting nested dicts."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = {} if d is None else dict(d)
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _convert(value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._convert(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, ConfigDict._convert(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def copy(self):
        return ConfigDict({k: (v.copy() if isinstance(v, ConfigDict) else v)
                           for k, v in self.items()})


cfg = ConfigDict()


def merge_new_config(config, new_config):
    """Recursively merge ``new_config`` into ``config``.

    A ``_BASE_CONFIG_`` key loads that YAML file first (path relative to the
    working directory, as in the JAX package); the new keys override it.
    """
    if '_BASE_CONFIG_' in new_config:
        with open(new_config['_BASE_CONFIG_'], 'r') as f:
            base_config = yaml.safe_load(f)
        config.update(ConfigDict(base_config))

    for key, val in new_config.items():
        if key == '_BASE_CONFIG_':
            continue
        if not isinstance(val, dict):
            config[key] = val
            continue
        if key not in config or not isinstance(config[key], dict):
            config[key] = ConfigDict()
        merge_new_config(config[key], val)
    return config


def cfg_from_yaml_file(cfg_file, config=None):
    """Load a YAML file into ``config`` (the global ``cfg`` by default)."""
    config = cfg if config is None else config
    with open(cfg_file, 'r') as f:
        new_config = yaml.safe_load(f)
    merge_new_config(config=config, new_config=new_config)
    return config
