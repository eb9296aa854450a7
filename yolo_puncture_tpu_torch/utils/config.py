"""Unified configuration tree.

Counterpart of ``yolo_puncture_tpu/utils/config.py``: one dataclass tree for
paths, the analytics constants, predict, track and train settings; a YAML file
overlays onto it.  ``yaml`` is imported only when a file is actually read, so
``load_config()`` works where PyYAML is not installed.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class PathConfig:
    """The reference config.yaml PATH keys."""

    DATASETS_PATH: str = "resources/datasets"
    WEIGHTS_PATH: str = "resources/weights"


@dataclass
class AnalyticsConfig:
    """Domain constants of the needle-speed pipeline."""

    init_shaft_len_mm: float = 20.0   # INIT_SHAFT_LEN: nominal needle-shaft length
    move_threshold_mm: float = 2.0    # MOVE_THRESHOLD: insertion distance measured
    confirmation_frames: int = 5      # CONFIRMATION_FRAMES: rolling calibration window
    out_expand_px: int = 50           # OUT_EXPAND: ROI expansion for rendering
    judge_wnd: int = 20               # key-frame voting window
    classifier_input_size: int = 380  # INPUT_IMG_SIZE
    num_classes: int = 2              # NUM_CLASSES
    gaussian_sigma: float = 3.0       # gaussian_smoothing default


@dataclass
class PredictConfig:
    imgsz: int = 640
    conf: float = 0.25          # ultralytics default; UI uses 0.9, batch CLI 0.35
    iou: float = 0.7            # NMS IoU threshold (v8/v11 path)
    max_det: int = 300
    retina_masks: bool = False
    dtype: str = "bfloat16"     # on-device compute dtype
    batch_size: int = 8         # frames per device step in the video pipeline


@dataclass
class TrackConfig:
    """DEVA-equivalent temporal propagation settings."""

    temporal_setting: str = "semionline"   # 'semionline' | 'online'
    detection_every: int = 5
    num_voting_frames: int = 3
    max_objects: int = 8
    size: int = 480                        # min-side resize for the tracker (-1 = off)
    suppress_small_objects: bool = True
    min_area_threshold: int = 100
    mem_every: int = 5                     # frames between working-memory writes
    max_mid_term_frames: int = 10
    min_mid_term_frames: int = 5
    num_prototypes: int = 128
    max_long_term_elements: int = 10000
    enable_long_term: bool = True
    enable_long_term_count_usage: bool = False
    top_k: int = 30                        # memory-readout top-k


@dataclass
class TrainConfig:
    epochs: int = 100
    batch_size: int = 16
    imgsz: int = 640
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    seg_gain: float = 1.0
    data_axis: str = "data"


@dataclass
class Config:
    PATH: PathConfig = field(default_factory=PathConfig)
    analytics: AnalyticsConfig = field(default_factory=AnalyticsConfig)
    predict: PredictConfig = field(default_factory=PredictConfig)
    track: TrackConfig = field(default_factory=TrackConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _overlay(obj: Any, d: Dict[str, Any]) -> Any:
    """Recursively overlay a dict onto a dataclass tree (unknown keys are ignored)."""
    if not dataclasses.is_dataclass(obj):
        return d
    updates = {}
    names = {f.name for f in dataclasses.fields(obj)}
    for k, v in d.items():
        if k not in names:
            continue
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            updates[k] = _overlay(cur, v)
        else:
            updates[k] = v
    return dataclasses.replace(obj, **updates)


_CONFIG: Optional[Config] = None


def load_config(yaml_path: Optional[str] = None) -> Config:
    """Build the config tree, overlaying a YAML file if present (by default
    ``config.yaml`` at the repository's root)."""
    cfg = Config()
    if yaml_path is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        candidate = os.path.join(root, "config.yaml")
        yaml_path = candidate if os.path.exists(candidate) else None
    if yaml_path and os.path.exists(yaml_path):
        import yaml

        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        cfg = _overlay(cfg, data)
    return cfg


def get_config() -> Config:
    """Process-wide config, loaded on first use."""
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = load_config()
    return _CONFIG
