"""Training utilities of the port (counterpart of the JAX ``utils/``) and its
config system, the JAX package's: a config is a plain ``.py`` file executed
as a module, and every public module-level name becomes an entry, read as an
attribute or as an item. Entry points take one ``--config`` path; the model
factory, optimiser, data loaders and knobs all come out of the config."""

from __future__ import annotations

import importlib.util
import os
import sys
import uuid
from pathlib import Path
from typing import Any, Mapping


class DictWrapper:
    """Attribute and item read-write view over a dict (``cfg.key``,
    ``cfg['key']``, ``in``, ``.get``, iteration and assignment)."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        object.__setattr__(self, "_data", dict(data or {}))

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __repr__(self) -> str:
        return f"{type(self).__name__}({sorted(self._data)})"

    def to_dict(self) -> dict:
        return dict(self._data)


class Config(DictWrapper):
    """Singleton config: repeated construction returns the same instance,
    which each :func:`get_config` call resets, so one process can load several
    configs one after the other."""

    _instance: "Config | None" = None

    def __new__(cls, data: Mapping[str, Any] | None = None):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            DictWrapper.__init__(cls._instance, {})
        if data:
            cls._instance._data.update(data)
        return cls._instance

    def __init__(self, data: Mapping[str, Any] | None = None):
        # __new__ already merged `data`; DictWrapper.__init__ would wipe it
        pass

    @classmethod
    def reset(cls) -> None:
        cls._instance = None


def _exec_config_module(path: str | os.PathLike):
    """Execute a Python file as an anonymous module and return it."""
    path = Path(path).resolve()
    if not path.exists():
        raise FileNotFoundError(f"config file not found: {path}")
    # a unique name, so that loading sibling configs does not collide
    name = f"_pfr_config_{path.stem}_{uuid.uuid4().hex[:8]}"
    spec = importlib.util.spec_from_file_location(name, str(path))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    finally:
        sys.modules.pop(name, None)
    return module


def _public_globals(module) -> dict:
    return {
        k: v
        for k, v in vars(module).items()
        if not k.startswith("_") and not isinstance(v, type(importlib))
    }


def get_dict_wrapper(path: str | os.PathLike) -> DictWrapper:
    """Load a config file into a plain (non-singleton) :class:`DictWrapper`."""
    module = _exec_config_module(path)
    wrapper = DictWrapper(_public_globals(module))
    wrapper["config_path"] = str(Path(path).resolve())
    return wrapper


def get_config(path: str | os.PathLike) -> Config:
    """Load a config file into the singleton :class:`Config` (reset first)."""
    Config.reset()
    module = _exec_config_module(path)
    cfg = Config(_public_globals(module))
    cfg["config_path"] = str(Path(path).resolve())
    return cfg


def is_main_process() -> bool:
    """True on the process that owns logging and the run directory: rank 0 of
    an initialised ``torch.distributed`` group, else the one whose
    ``NODE_RANK`` and ``LOCAL_RANK`` are 0 or unset."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return os.environ.get("NODE_RANK", "0") == "0" and (
        os.environ.get("LOCAL_RANK", "0") == "0"
    )
