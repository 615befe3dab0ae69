"""YAML configs with ``_BASE_CONFIG_`` inheritance, attribute access and
dotted-key overrides.

The port's own copy of ``hvpr_tpu/config.py`` (``ConfigDict``, the global
``cfg`` with ``ROOT_DIR`` from ``HVPR_ROOT_DIR`` or the repository root,
``merge_new_config``, ``cfg_from_yaml_file``, ``cfg_from_list``,
``log_config_to_file``): it reads the same files under ``tools/cfgs/`` and
yields the same nested dicts.
"""

import ast
import os
from pathlib import Path

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
cfg.ROOT_DIR = Path(os.environ.get('HVPR_ROOT_DIR',
                                   Path(__file__).resolve().parent.parent))
cfg.LOCAL_RANK = 0


def log_config_to_file(cfg_=None, pre='cfg', logger=None):
    """Log every key of ``cfg_`` (the global ``cfg`` by default), one line
    each, nested sections under a header."""
    cfg_ = cfg if cfg_ is None else cfg_
    for key, val in cfg_.items():
        if isinstance(val, ConfigDict):
            logger.info('----------- %s.%s -----------', pre, key)
            log_config_to_file(val, pre=f'{pre}.{key}', logger=logger)
        else:
            logger.info('%s.%s: %s', pre, key, val)


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


def cfg_from_list(cfg_list, config=None):
    """Set config keys from a ``[key, value, key, value, ...]`` list of
    dotted keys. Values are parsed as Python literals where they parse
    (else kept as strings) and must match the type of the entry they
    replace (an int may replace a float); a dict merges into the subtree.
    """
    config = cfg if config is None else config
    if len(cfg_list) % 2:
        raise ValueError(f'--set takes key value pairs, got {cfg_list}')
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = full_key.split('.')
        d = config
        for subkey in key_list[:-1]:
            if subkey not in d:
                raise KeyError(f'NotFoundKey: {subkey}')
            d = d[subkey]
        subkey = key_list[-1]
        if subkey not in d:
            raise KeyError(f'NotFoundKey: {subkey}')
        try:
            value = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            value = v

        if isinstance(value, dict):
            merge_new_config(d[subkey], ConfigDict(value))
            continue
        old = d[subkey]
        if old is not None and not isinstance(value, type(old)) \
                and not (isinstance(old, float) and isinstance(value, int)):
            raise TypeError(f'{full_key}: type {type(value)} does not match '
                            f'original type {type(old)}')
        d[subkey] = value
    return config
