"""Python-file config system compatible with the reference's mmcv.Config usage.

The reference loads configs via ``mmcv.Config.fromfile`` (run.py:500) with
``_base_`` inheritance and field-wise dict override (configs/nerf/lego.py).
This is a small self-contained reimplementation of the subset the reference
relies on:

  * a config is a python file executed in an empty namespace
  * ``_base_`` (str or list of str, relative to the config file) is loaded
    first; child values override base values with *recursive dict merge*
  * attribute-style access on nested dicts, ``keys()``, ``get``, deepcopy
  * ``cfg.dump(path)`` writes a resolved, re-loadable python file
"""

from __future__ import annotations

import copy
import os
import pprint
import types


class ConfigDict(dict):
    """A dict with attribute access; nested dicts are wrapped on the fly."""

    def __getattr__(self, name):
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
            self[name] = value
        return value

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def __getitem__(self, key):
        value = dict.__getitem__(self, key)
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
            dict.__setitem__(self, key, value)
        return value

    def get(self, key, default=None):
        if key in self:
            return self[key]
        return default


def _merge(base, child):
    """Recursively merge ``child`` over ``base`` (child wins; dicts merge)."""
    if not isinstance(base, dict) or not isinstance(child, dict):
        return copy.deepcopy(child)
    out = dict(copy.deepcopy(base))
    for k, v in child.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _exec_config_file(path):
    path = os.path.abspath(path)
    with open(path) as f:
        source = f.read()
    namespace = {"__file__": path}
    code = compile(source, path, "exec")
    exec(code, namespace)
    cfg = {
        k: v
        for k, v in namespace.items()
        if not k.startswith("__") and not isinstance(v, types.ModuleType)
        and not callable(v)
    }
    return cfg


def _load_dict(path):
    cfg = _exec_config_file(path)
    bases = cfg.pop("_base_", None)
    if bases is None:
        return cfg
    if isinstance(bases, str):
        bases = [bases]
    merged = {}
    for base_rel in bases:
        base_path = os.path.join(os.path.dirname(os.path.abspath(path)), base_rel)
        merged = _merge(merged, _load_dict(base_path))
    return _merge(merged, cfg)


class Config(ConfigDict):
    """Top-level config object. Use :meth:`fromfile` to load."""

    @classmethod
    def fromfile(cls, path):
        cfg = cls(_load_dict(path))
        dict.__setattr__(cfg, "_source_path", os.path.abspath(path))
        return cfg

    def dump(self, path):
        with open(path, "w") as f:
            f.write("# Resolved config dump (re-loadable python)\n")
            for k, v in self.items():
                f.write(f"{k} = {pprint.pformat(_plain(v), width=100)}\n")

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v
