"""Weight bridge: JAX variables, flax msgpack files and ultralytics ``.pt`` files → the port's state_dicts.

The port's YOLO modules carry ultralytics state-dict names
(``model.0.conv.weight``, ``model.23.one2one_cv3.0.0.0.conv.weight``, …), so an
ultralytics checkpoint loads by name and the JAX package's flax variables need
only a key map and a layout change:

  * conv kernels HWIO → OIHW, dense kernels transposed;
  * ``ConvTranspose`` kernels (the Proto upsample) are also flipped spatially:
    flax's ConvTranspose cross-correlates the dilated input where torch's
    convolves.  Without the flip Proto is wrong while the rest of the forward
    still runs.

This is the port's own copy of the JAX package's ``utils/torch_convert.py``
(``yolo_flax_path_to_torch_key``, ``export_yolo_state_dict`` and the
stub-unpickler ``.pt`` reader); the port imports nothing from that package.

``read_msgpack`` reads the checkpoints that ``flax.serialization`` wrote
(``resources/weights/*.msgpack``) with neither flax nor the ``msgpack`` package:
a small decoder of the msgpack wire format, with flax's extension type 1 (an
ndarray packed as ``(shape, dtype name, bytes)``).  ``export_tracker_state_dict``
maps the tracker's variable tree onto ``track/network.py PropagationNetwork``:
the port's modules carry the flax attribute names and concatenate channels in
the JAX package's order, so the map is HWIO → OIHW plus the BatchNorm leaf names.
``export_classifier_state_dict`` maps the JAX package's EfficientNet variables
onto timm's keys (``blocks_{s}_{i}`` → ``blocks.{s}.{i}``), the keys the port's
``models/efficientnet.py`` carries, so a timm checkpoint and a JAX variable tree
load through the same ``load_classifier_state_dict``.  ``export_u2net_state_dict``
maps the JAX package's U²-Net variables onto the reference's torch names, which
``models/u2net.py`` carries.
"""

from __future__ import annotations

import pickle
import re
import struct
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Reading torch files without the original class definitions
# ---------------------------------------------------------------------------


class _Stub:
    """Placeholder for classes that cannot be imported (ultralytics model wrappers)."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __call__(self, *a, **k):  # some reduces call the class
        return self


def _stub_class(module: str, name: str):
    return type(name, (_Stub,), {"__module__": module})


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _stub_class(module, name)


def load_torch_file(path: str):
    """``torch.load`` on the CPU, with classes that cannot be imported stubbed out.

    Only for checkpoints the user trusts: the fallback unpickles arbitrary objects."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        pass
    return torch.load(
        path,
        map_location="cpu",
        weights_only=False,
        pickle_module=type("M", (), {"Unpickler": _StubUnpickler, "load": pickle.load}),
    )


def _walk_module_tree(obj, prefix: str, out: Dict[str, np.ndarray]):
    """Parameters and buffers of a (possibly stubbed) pickled nn.Module tree."""
    d = getattr(obj, "__dict__", None)
    if d is None:
        return
    for coll in ("_parameters", "_buffers"):
        for k, v in (d.get(coll) or {}).items():
            if v is not None and hasattr(v, "detach"):
                out[prefix + k] = v.detach().cpu().numpy()
    for k, v in (d.get("_modules") or {}).items():
        _walk_module_tree(v, f"{prefix}{k}.", out)


def extract_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Flat ``name → ndarray`` from an ultralytics ``.pt`` or a raw state-dict ``.pth``."""
    obj = load_torch_file(path)

    def tensors_of(d):
        return {
            k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
            for k, v in d.items()
            if hasattr(v, "detach") or isinstance(v, np.ndarray)
        }

    if isinstance(obj, dict):
        for key in ("state_dict", "model_state_dict", "ema", "model"):
            if key not in obj:
                continue
            inner = obj[key]
            if isinstance(inner, dict):
                sd = tensors_of(inner)
                if sd:
                    return sd
            elif isinstance(inner, torch.nn.Module):
                return tensors_of(inner.state_dict())
            out: Dict[str, np.ndarray] = {}
            _walk_module_tree(inner, "", out)
            if out:
                return out
        sd = tensors_of(obj)
        if sd:
            return sd
    out = {}
    _walk_module_tree(obj, "", out)
    if out:
        return out
    raise ValueError(f"could not extract a state dict from {path}")


# ---------------------------------------------------------------------------
# Flax variables → ultralytics-keyed state dict
# ---------------------------------------------------------------------------

_INV_HEAD_NESTED = re.compile(r"(one2one_)?cv([234])_(\d+)\.c(\d+)_(\d+)\.")
_INV_HEAD_FLAT = re.compile(r"(one2one_)?cv([234])_(\d+)\.c(\d+)\.")
_INV_CIB = re.compile(r"cv1_(\d+)\.")
_INV_M = re.compile(r"(?:^|(?<=\.))m_(\d+)\.")
_INV_FFN = re.compile(r"ffn_(\d+)\.")
_INV_MODEL = re.compile(r"^model_(\d+)\.")
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def yolo_flax_path_to_torch_key(path, leaf: str) -> str:
    """flax module path + leaf name → ultralytics state-dict key."""
    k = ".".join(path) + "."
    k = _INV_MODEL.sub(lambda m: f"model.{m.group(1)}.", k)
    k = _INV_HEAD_NESTED.sub(
        lambda m: f"{m.group(1) or ''}cv{m.group(2)}.{m.group(3)}.{m.group(4)}.{m.group(5)}.", k
    )
    k = _INV_HEAD_FLAT.sub(
        lambda m: f"{m.group(1) or ''}cv{m.group(2)}.{m.group(3)}.{m.group(4)}.", k
    )
    k = _INV_CIB.sub(lambda m: f"cv1.{m.group(1)}.", k)
    k = _INV_M.sub(lambda m: f"m.{m.group(1)}.", k)
    k = _INV_FFN.sub(lambda m: f"ffn.{m.group(1)}.", k)
    return k + _LEAF[leaf]


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def export_yolo_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX YOLO variables (nested dicts of arrays: ``params`` + ``batch_stats``)
    → torch-layout state dict with ultralytics names, as numpy arrays."""
    out: Dict[str, np.ndarray] = {}
    for tree in (variables["params"], variables.get("batch_stats", {})):
        for path, arr in _flatten(tree).items():
            leaf = path[-1]
            a = np.asarray(arr)
            if leaf == "kernel" and a.ndim == 4:
                if path[-2] == "upsample":  # ConvTranspose (kh, kw, I, O) → (I, O, kh, kw), flipped
                    a = np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1))
                else:  # Conv (kh, kw, I/g, O) → (O, I/g, kh, kw)
                    a = a.transpose(3, 2, 0, 1)
            elif leaf == "kernel" and a.ndim == 2:
                a = a.T
            out[yolo_flax_path_to_torch_key(path[:-1], leaf)] = a
    return out


def load_yolo_state_dict(model: torch.nn.Module, sd: Mapping[str, Any]) -> None:
    """Load an ultralytics-keyed state dict (numpy or torch values) into a port
    YOLO model.  Every parameter and running statistic must be present; the
    only keys allowed to go unused are DFL's fixed projection (the port decodes
    DFL without a parameter).  BatchNorm's ``num_batches_tracked`` may be absent."""
    tensors = {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    unexpected = [k for k in unexpected if ".dfl." not in k]
    if missing or unexpected:
        raise ValueError(
            f"state dict does not fit the model: missing {missing[:8]}, unexpected {unexpected[:8]}"
        )


# ---------------------------------------------------------------------------
# flax msgpack files
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3  # flax.serialization's extension types


class _MsgpackReader:
    """Decoder for the subset of msgpack that flax checkpoints use: maps, arrays,
    strings, integers, floats, booleans, nil, bin and ext."""

    _FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
              0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    _LEN = {1: ">B", 2: ">H", 4: ">I"}

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside a value")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _uint(self, width: int) -> int:
        return struct.unpack(self._LEN[width], self._take(width))[0]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = struct.unpack(">b", self._take(1))[0]
        payload = bytes(self._take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype_name, raw = _MsgpackReader(payload).read()
            try:
                dtype = np.dtype(dtype_name)
            except TypeError as e:
                raise NotImplementedError(f"msgpack ndarray of dtype {dtype_name!r} is not read") from e
            arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
            return arr if code == _EXT_NDARRAY else arr[()]
        raise NotImplementedError(f"msgpack extension type {code} is not read")

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return bytes(self._take(b & 0x1F)).decode("utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self._take(self._uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            return self._ext(self._uint(1 << (b - 0xC7)))
        if b in self._FIXED:
            fmt = self._FIXED[b]
            return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return bytes(self._take(self._uint(1 << (b - 0xD9)))).decode("utf-8")
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self._uint(2 << (b - 0xDC)))]
        if b in (0xDE, 0xDF):
            return self._map(self._uint(2 << (b - 0xDE)))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")


def read_msgpack(src) -> Any:
    """Decode a flax msgpack checkpoint (a path or its bytes) into nested dicts
    of numpy arrays, as ``flax.serialization.msgpack_restore`` does."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        data = bytes(src)
    else:
        with open(src, "rb") as f:
            data = f.read()
    reader = _MsgpackReader(data)
    out = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes left over after the msgpack value")
    return out


# ---------------------------------------------------------------------------
# Tracker variables → PropagationNetwork state dict
# ---------------------------------------------------------------------------


def tracker_flax_path_to_torch_key(path: Tuple[str, ...], leaf: str) -> str:
    """flax module path + leaf name of a tracker variable → the port's key
    (``('decoder', 'dec8', 'conv')``, ``'kernel'`` → ``decoder.dec8.conv.weight``;
    C2f's ``m_0`` is ``m.0`` in the port's ModuleList)."""
    return _INV_M.sub(lambda m: f"m.{m.group(1)}.", ".".join(path) + ".") + _LEAF[leaf]


def export_tracker_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """Tracker variables (``params`` + ``batch_stats`` nested dicts, from
    ``read_msgpack`` or the JAX package) → state dict of the port's
    ``PropagationNetwork``, as numpy arrays: conv kernels HWIO → OIHW."""
    out: Dict[str, np.ndarray] = {}
    for tree in (variables["params"], variables.get("batch_stats", {})):
        for path, arr in _flatten(tree).items():
            a = np.asarray(arr)
            if path[-1] == "kernel":
                a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
            out[tracker_flax_path_to_torch_key(path[:-1], path[-1])] = a
    return out


def load_tracker_state_dict(model: torch.nn.Module, sd: Mapping[str, Any]) -> None:
    """Load ``export_tracker_state_dict``'s output into a ``PropagationNetwork``.
    Every parameter and running statistic must be present and used."""
    tensors = {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(
            f"state dict does not fit the tracker: missing {missing[:8]}, unexpected {list(unexpected)[:8]}"
        )


# ---------------------------------------------------------------------------
# Classifier variables → timm-keyed EfficientNet state dict
# ---------------------------------------------------------------------------

_FLAX_BLOCK = re.compile(r"(?:^|(?<=\.))blocks_(\d+)_(\d+)\.")


def export_classifier_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """The JAX package's EfficientNet variables (``params`` + ``batch_stats``)
    → timm-keyed state dict of numpy arrays: conv kernels HWIO → OIHW (a
    depthwise ``(k, k, 1, C)`` becomes ``(C, 1, k, k)``), Dense ``(in, out)`` →
    ``(out, in)``, ``scale`` → ``weight``, ``mean`` / ``var`` → ``running_*``."""
    out: Dict[str, np.ndarray] = {}
    for tree in (variables["params"], variables.get("batch_stats", {})):
        for path, arr in _flatten(tree).items():
            a = np.asarray(arr)
            if path[-1] == "kernel":
                a = np.ascontiguousarray(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)
            key = _FLAX_BLOCK.sub(lambda m: f"blocks.{m.group(1)}.{m.group(2)}.", ".".join(path[:-1]) + ".")
            out[key + _LEAF[path[-1]]] = a
    return out


def load_classifier_state_dict(model: torch.nn.Module, sd: Mapping[str, Any]) -> None:
    """Load a timm-keyed state dict (numpy or torch values; a timm checkpoint or
    ``export_classifier_state_dict``'s output) into the port's EfficientNet.
    Strict: every parameter and running statistic must be present and every key
    used; only BatchNorm's ``num_batches_tracked`` may be absent or extra."""
    tensors = {k: torch.tensor(np.asarray(v)) for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(
            f"state dict does not fit the classifier: missing {missing}, unexpected {list(unexpected)}"
        )


# ---------------------------------------------------------------------------
# U²-Net variables → the reference's torch-named state dict
# ---------------------------------------------------------------------------


def export_u2net_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """The JAX package's U²-Net / U2NETP variables (``params`` + ``batch_stats``)
    → the reference's raw state dict as numpy arrays (``stage1.rebnconvin.conv_s1.weight``,
    ``…bn_s1.running_mean``, ``side1.bias``, ``outconv.weight``): the module paths
    are the torch names already; conv kernels HWIO → OIHW."""
    out: Dict[str, np.ndarray] = {}
    for tree in (variables["params"], variables.get("batch_stats", {})):
        for path, arr in _flatten(tree).items():
            a = np.asarray(arr)
            if path[-1] == "kernel":
                a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
            out[".".join(path[:-1]) + "." + _LEAF[path[-1]]] = a
    return out
