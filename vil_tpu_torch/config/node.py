"""A minimal yacs-compatible configuration node.

Provides the subset of the yacs ``CfgNode`` API that the reference framework
relies on (its config/__init__.py:2 and run_experiment.py:65-66):
attribute access, YAML overlay
via ``merge_from_file``, dotted-key CLI overrides via ``merge_from_list``,
``freeze``/``defrost``, and ``dump``.

This is a clean-room implementation: plain dict subclass, no external deps
beyond PyYAML. A copy of ``vil_tpu/config/node.py``.
"""
from __future__ import annotations

import copy
from typing import Any, Iterable

import yaml

_FROZEN = "__frozen__"
_NEW_ALLOWED = "__new_allowed__"


class CfgNode(dict):
    """Hierarchical config with attribute access and freezing."""

    def __init__(self, init_dict: dict | None = None, new_allowed: bool = False):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        object.__setattr__(self, _NEW_ALLOWED, new_allowed)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = self._to_node(v, new_allowed)

    @staticmethod
    def _to_node(value: Any, new_allowed: bool = False) -> Any:
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            return CfgNode(value, new_allowed=new_allowed)
        return value

    # -- attribute access ----------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        if name not in self and not object.__getattribute__(self, _NEW_ALLOWED):
            # Mirrors yacs: only keys declared in defaults may be set, unless
            # the node was created with new_allowed=True (AUG.TIMM_AUG).
            raise KeyError(f"Non-existent config key: {name}")
        super().__setitem__(name, self._to_node(value))

    def update_unchecked(self, name: str, value: Any) -> None:
        """Set a key bypassing the new-key check (used while building defaults)."""
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError("CfgNode is immutable")
        super().__setitem__(name, self._to_node(value))

    # -- freezing ------------------------------------------------------------
    def freeze(self) -> None:
        self._set_frozen(True)

    def defrost(self) -> None:
        self._set_frozen(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    def _set_frozen(self, frozen: bool) -> None:
        object.__setattr__(self, _FROZEN, frozen)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(frozen)

    # -- merging -------------------------------------------------------------
    def merge_from_file(self, cfg_filename: str) -> None:
        with open(cfg_filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded:
            self._merge_dict(loaded)

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(other)

    def _merge_dict(self, d: dict, prefix: str = "") -> None:
        for k, v in d.items():
            full = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                if k not in self:
                    if object.__getattribute__(self, _NEW_ALLOWED):
                        super().__setitem__(k, CfgNode(v, new_allowed=True))
                        continue
                    raise KeyError(f"Non-existent config key: {full}")
                node = self[k]
                if isinstance(node, CfgNode):
                    node._merge_dict(v, full)
                else:
                    self[k] = v
            else:
                if k not in self and not object.__getattribute__(self, _NEW_ALLOWED):
                    raise KeyError(f"Non-existent config key: {full}")
                existing = self.get(k, None)
                if isinstance(v, str):
                    # yacs semantics: strings from YAML/CLI are python-literal
                    # decoded first ('5e-4' -> 0.0005, "('a',)" -> tuple)
                    v = _decode_value(v)
                super().__setitem__(k, _coerce(v, existing, full))

    def merge_from_list(self, cfg_list: Iterable[Any]) -> None:
        cfg_list = list(cfg_list)
        assert len(cfg_list) % 2 == 0, (
            f"Override list has odd length: {cfg_list}"
        )
        for key, value in zip(cfg_list[0::2], cfg_list[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node and not object.__getattribute__(node, _NEW_ALLOWED):
                raise KeyError(f"Non-existent config key: {key}")
            existing = node.get(leaf, None)
            if isinstance(value, str):
                value = _decode_value(value)
            dict.__setitem__(node, leaf, _coerce(value, existing, str(key)))

    # -- misc ----------------------------------------------------------------
    def clone(self) -> "CfgNode":
        c = copy.deepcopy(self)
        c._set_frozen(False)
        return c

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else copy.deepcopy(v))
            for k, v in self.items()
        }

    def dump(self, **kwargs) -> str:
        return yaml.safe_dump(self.to_dict(), **kwargs)

    def __deepcopy__(self, memo):
        new = CfgNode(new_allowed=object.__getattribute__(self, _NEW_ALLOWED))
        for k, v in self.items():
            dict.__setitem__(new, k, copy.deepcopy(v, memo))
        return new

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


def _decode_value(value: str) -> Any:
    """Parse a CLI string override the way yacs does (python literal first)."""
    import ast

    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(value: Any, existing: Any, key: str) -> Any:
    """Light type reconciliation between override and default value."""
    if existing is None:
        return CfgNode._to_node(value)
    if isinstance(existing, bool) and isinstance(value, int):
        return bool(value)
    if isinstance(existing, float) and isinstance(value, int):
        return float(value)
    if isinstance(existing, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(existing, list) and isinstance(value, tuple):
        return list(value)
    if type(value) is type(existing) or existing is None:
        return value
    if isinstance(existing, (int, float)) and isinstance(value, (int, float)):
        return value
    if isinstance(existing, str) or isinstance(value, str):
        return value
    if isinstance(existing, (list, tuple)):
        return value
    raise ValueError(
        f"Type mismatch for key {key}: cannot override "
        f"{type(existing).__name__} with {type(value).__name__}"
    )
