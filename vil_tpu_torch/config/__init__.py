"""Configuration system: yacs-compatible CfgNode + default schema.

A copy of ``vil_tpu/config``, so that one YAML file and one list of dotted
overrides configure both packages alike. Usage mirrors the reference
framework's ``config/__init__.py``: import ``cfg`` for the process-global
config, or build a fresh one with ``get_default_cfg()`` (preferred for tests
and library use — no global state).
"""
from .node import CfgNode
from .defaults import get_default_cfg

# Process-global config for CLI compatibility with the reference
# (reference run_experiment.py mutates a module-level singleton).
cfg = get_default_cfg()

__all__ = ["CfgNode", "cfg", "get_default_cfg"]
