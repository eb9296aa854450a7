"""Model registry: a name → a constructor that returns an ``nn.Module``.

Counterpart of ``yolo_puncture_tpu/registry.py`` (the reference's timm string
dispatch, ``timm.create_model(name, num_classes=...)``).  Importing the package
fills it: ``models/yolo.py`` registers the YOLO names, ``models/efficientnet.py``
``efficientnet_b0`` … ``efficientnet_b7``, ``models/u2net.py`` ``u2net`` and
``u2netp``, ``models/van.py`` ``van_b0`` … ``van_b6``: the JAX package's names.
``models/sam.py`` adds ``sam`` when it is imported.
"""

from __future__ import annotations

from typing import Callable, Dict

_MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(fn: Callable = None, *, name: str = None):
    """Decorator: register a model constructor under its function name (or ``name``)."""

    def _register(f):
        _MODEL_REGISTRY[name or f.__name__] = f
        return f

    if fn is not None:
        return _register(fn)
    return _register


def create_model(name: str, **kwargs):
    """Instantiate a registered model by name (``timm.create_model`` equivalent)."""
    if name not in _MODEL_REGISTRY:
        raise KeyError(f"Unknown model '{name}'. Registered: {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[name](**kwargs)


def list_models() -> list:
    return sorted(_MODEL_REGISTRY)
