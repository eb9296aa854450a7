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
onto timm's keys (``blocks_{s}_{i}`` → ``blocks.{s}.{i}``) and its VAN variables
onto the published VAN keys (``block{s}_{i}`` → ``block{s}.{i}``, ``mlp.dwconv`` →
``mlp.dwconv.dwconv``), the keys the port's ``models/efficientnet.py`` and
``models/van.py`` carry, so a checkpoint and a JAX variable tree load through the
same ``load_classifier_state_dict``.  ``export_u2net_state_dict``
maps the JAX package's U²-Net variables onto the reference's torch names, which
``models/u2net.py`` carries.

``export_sam_state_dict`` maps the JAX package's SAM variables onto
segment-anything's keys, which ``models/sam.py`` carries (the inverse of the JAX
package's ``_SAM_RENAMES`` and of its ConvTranspose flip), and
``load_sam_state_dict`` loads such a dict or a released ``sam_vit_*.pth``
strictly, interpolating ``pos_embed`` and the rel-pos tables to another image size.

The other way: ``yolo_variables`` turns a YOLO state dict back into the JAX
package's flax variables and ``tracker_variables`` a ``PropagationNetwork``
state dict into the tracker's flax variable tree, and ``write_msgpack`` encodes such a
tree as ``flax.serialization.msgpack_serialize`` does (keys sorted, ndarrays as
extension type 1), so a checkpoint the port trains loads in both packages
(``export_tracker_msgpack``).
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


_PORT_MODEL = re.compile(r"^model\.(\d+)\.")
_PORT_HEAD_NESTED = re.compile(r"(one2one_)?cv([234])\.(\d+)\.(\d+)\.(\d+)\.")
_PORT_HEAD_FLAT = re.compile(r"(one2one_)?cv([234])\.(\d+)\.(\d+)\.")
_PORT_CIB = re.compile(r"cv1\.(\d+)\.")
_PORT_M = re.compile(r"(?:^|(?<=\.))m\.(\d+)\.")
_PORT_FFN = re.compile(r"ffn\.(\d+)\.")
_LEAF_BACK = {"running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var"),
              "bias": ("params", "bias")}


def yolo_module_path(name: str) -> Tuple[str, ...]:
    """A module name of the port's YOLO (``model.2.m.0.cv1.conv``) → the JAX
    package's flax module path (``('model_2', 'm_0', 'cv1', 'conv')``)."""
    k = _PORT_MODEL.sub(lambda m: f"model_{m.group(1)}.", name + ".")
    k = _PORT_HEAD_NESTED.sub(
        lambda m: f"{m.group(1) or ''}cv{m.group(2)}_{m.group(3)}.c{m.group(4)}_{m.group(5)}.", k)
    k = _PORT_HEAD_FLAT.sub(lambda m: f"{m.group(1) or ''}cv{m.group(2)}_{m.group(3)}.c{m.group(4)}.", k)
    k = _PORT_CIB.sub(lambda m: f"cv1_{m.group(1)}.", k)
    k = _PORT_M.sub(lambda m: f"m_{m.group(1)}.", k)
    k = _PORT_FFN.sub(lambda m: f"ffn_{m.group(1)}.", k)
    return tuple(k[:-1].split("."))


def yolo_variables(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """An ultralytics-keyed YOLO state dict (the port's ``YOLOModel.state_dict()``)
    → the JAX package's flax variable tree (``params`` / ``batch_stats`` nested
    dicts of fp32 numpy arrays), the inverse of ``export_yolo_state_dict``: the
    key map run backwards, OIHW → HWIO, the ``ConvTranspose`` kernel flipped back,
    BatchNorm's ``weight`` → ``scale``.  Each key must map back to itself through
    ``yolo_flax_path_to_torch_key``, or this raises."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        k, leaf = key.rsplit(".", 1)
        path = yolo_module_path(k)
        a = np.asarray(value.detach().cpu().float() if isinstance(value, torch.Tensor) else value, np.float32)
        if leaf == "weight" and a.ndim == 4:
            collection, name = "params", "kernel"
            a = a.transpose(2, 3, 0, 1)[::-1, ::-1] if path[-1] == "upsample" else a.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            collection, name = "params", ("kernel" if a.ndim == 2 else "scale")
            a = a.T if a.ndim == 2 else a
        else:
            collection, name = _LEAF_BACK[leaf]
        if yolo_flax_path_to_torch_key(path, name) != key:
            raise ValueError(f"cannot map '{key}' to a flax path of the JAX package's YOLO")
        node = out[collection]
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(a)
    return out


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


class _MsgpackWriter:
    """Encoder for the same subset, with the smallest encoding of each value, as
    the ``msgpack`` package's ``packb(use_bin_type=True)`` chooses it."""

    def __init__(self):
        self.out = bytearray()

    def _head(self, n: int, fix: int, fix_max: int, codes) -> None:
        """A length header: the fix form below ``fix_max``, else 8/16/32-bit lengths."""
        if n <= fix_max:
            self.out.append(fix | n)
            return
        for code, fmt in codes:
            if n < 1 << (8 * struct.calcsize(fmt)):
                self.out += bytes([code]) + struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack length {n} too large")

    def _ext(self, code: int, payload: bytes) -> None:
        n = len(payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.out.append(fixed[n])
        else:
            self._head(n, 0, -1, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
        self.out += struct.pack(">b", code) + payload

    def write(self, x) -> None:
        if x is None:
            self.out.append(0xC0)
        elif isinstance(x, bool):
            self.out.append(0xC3 if x else 0xC2)
        elif isinstance(x, int):
            self._int(x)
        elif isinstance(x, float):
            self.out += b"\xcb" + struct.pack(">d", x)
        elif isinstance(x, str):
            raw = x.encode("utf-8")
            self._head(len(raw), 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
            self.out += raw
        elif isinstance(x, (bytes, bytearray)):
            self._head(len(x), 0, -1, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
            self.out += x
        elif isinstance(x, (list, tuple)):
            self._head(len(x), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I")))
            for v in x:
                self.write(v)
        elif isinstance(x, Mapping):
            self._head(len(x), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I")))
            for k in sorted(x):
                self.write(str(k))
                self.write(x[k])
        elif isinstance(x, (np.ndarray, np.generic, torch.Tensor)):
            arr = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
            inner = _MsgpackWriter()
            inner.write((tuple(int(d) for d in arr.shape), arr.dtype.name, arr.tobytes("C")))
            self._ext(_EXT_NPSCALAR if isinstance(x, np.generic) else _EXT_NDARRAY, bytes(inner.out))
        else:
            raise TypeError(f"msgpack cannot encode {type(x).__name__}")

    def _int(self, x: int) -> None:
        if 0 <= x <= 0x7F or -32 <= x < 0:
            self.out += struct.pack(">b" if x < 0 else ">B", x)
            return
        fmts = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if x >= 0 else \
            ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
        for code, fmt in fmts:
            try:
                self.out += bytes([code]) + struct.pack(fmt, x)
                return
            except struct.error:
                continue
        raise ValueError(f"integer {x} out of msgpack's range")


def write_msgpack(tree, dst=None) -> bytes:
    """Encode nested dicts of arrays (numpy or torch) as a flax msgpack
    checkpoint, the bytes ``flax.serialization.msgpack_serialize`` gives (keys
    sorted; arrays over 2^30 bytes, which flax would chunk, are not written);
    writes them to the path ``dst`` when given.  ``read_msgpack`` reads them
    back."""
    w = _MsgpackWriter()
    w.write(tree)
    data = bytes(w.out)
    if dst is not None:
        with open(dst, "wb") as f:
            f.write(data)
    return data


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


_TRACKER_LEAF = {"running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var"),
                 "bias": ("params", "bias")}


def tracker_variables(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A ``PropagationNetwork`` state dict → the tracker's flax variable tree
    (``params`` / ``batch_stats`` nested dicts of fp32 numpy arrays), the inverse
    of ``export_tracker_state_dict``: OIHW → HWIO, ``m.0`` → ``m_0``, BatchNorm's
    ``weight`` → ``scale``."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        path, leaf = _PORT_M.sub(lambda m: f"m_{m.group(1)}.", key).rsplit(".", 1)
        a = np.asarray(value.detach().cpu().float() if isinstance(value, torch.Tensor) else value, np.float32)
        if leaf == "weight":
            collection, name = ("params", "kernel") if a.ndim == 4 else ("params", "scale")
            a = np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 else a
        else:
            collection, name = _TRACKER_LEAF[leaf]
        node = out[collection]
        for part in path.split("."):
            node = node.setdefault(part, {})
        node[name] = a
    return out


def export_tracker_msgpack(net: torch.nn.Module, dst=None) -> bytes:
    """The tracker's weights as a flax msgpack checkpoint (``write_msgpack`` of
    ``tracker_variables``): ``flax.serialization.from_bytes`` of the JAX package's
    ``TrackerCore`` variables and the port's ``TrackerCore(variables=path)`` both
    read it."""
    return write_msgpack(tracker_variables(net.state_dict()), dst)


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
# Classifier variables → timm-keyed EfficientNet and published-keyed VAN state dicts
# ---------------------------------------------------------------------------

_FLAX_BLOCK = re.compile(r"(?:^|(?<=\.))blocks_(\d+)_(\d+)\.")
_FLAX_VAN_BLOCK = re.compile(r"(?:^|(?<=\.))block(\d+)_(\d+)\.")
_FLAX_VAN_DWCONV = re.compile(r"(?:^|(?<=\.))dwconv\.")


def classifier_flax_path_to_torch_key(path: Tuple[str, ...], leaf: str) -> str:
    """flax module path + leaf → the classifier's torch key: EfficientNet's
    ``blocks_{s}_{i}`` → ``blocks.{s}.{i}``; VAN's ``block{s}_{i}`` → ``block{s}.{i}``
    and its MLP's ``dwconv`` → ``dwconv.dwconv`` (the published ``DWConv`` wraps
    its convolution); a leaf that is not a kernel, scale, bias or statistic (VAN's
    ``layer_scale_1``) keeps its name."""
    key = ".".join(path) + "."
    key = _FLAX_BLOCK.sub(lambda m: f"blocks.{m.group(1)}.{m.group(2)}.", key)
    key = _FLAX_VAN_BLOCK.sub(lambda m: f"block{m.group(1)}.{m.group(2)}.", key)
    key = _FLAX_VAN_DWCONV.sub("dwconv.dwconv.", key)
    return (key if path else "") + _LEAF.get(leaf, leaf)


def export_classifier_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """The JAX package's EfficientNet or VAN variables (``params`` +
    ``batch_stats``) → timm-keyed (EfficientNet) or published-keyed (VAN) state
    dict of numpy arrays: conv kernels HWIO → OIHW (a depthwise ``(k, k, 1, C)``
    becomes ``(C, 1, k, k)``), Dense ``(in, out)`` → ``(out, in)``, ``scale`` →
    ``weight`` (BatchNorm and LayerNorm), ``mean`` / ``var`` → ``running_*``,
    VAN's layer scales as they are (``classifier_flax_path_to_torch_key``)."""
    out: Dict[str, np.ndarray] = {}
    for tree in (variables["params"], variables.get("batch_stats", {})):
        for path, arr in _flatten(tree).items():
            a = np.asarray(arr)
            if path[-1] == "kernel":
                a = np.ascontiguousarray(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)
            out[classifier_flax_path_to_torch_key(path[:-1], path[-1])] = a
    return out


def load_classifier_state_dict(model: torch.nn.Module, sd: Mapping[str, Any]) -> None:
    """Load a timm-keyed (EfficientNet) or published-keyed (VAN) state dict (numpy
    or torch values; a checkpoint or ``export_classifier_state_dict``'s output)
    into the port's classifier.
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


# ---------------------------------------------------------------------------
# SAM: JAX variables → segment-anything keys; checkpoints into the port's SAM
# ---------------------------------------------------------------------------

# the JAX package's flax paths (dotted) → segment-anything's keys: the inverse of its _SAM_RENAMES
_SAM_EXPORT = [
    (re.compile(r"^image_encoder\.patch_embed_proj\."), "image_encoder.patch_embed.proj."),
    (re.compile(r"^image_encoder\.block_(\d+)\.mlp_fc(\d)\."), r"image_encoder.blocks.\1.mlp.lin\2."),
    (re.compile(r"^image_encoder\.block_(\d+)\."), r"image_encoder.blocks.\1."),
    (re.compile(r"^image_encoder\.neck_conv1\."), "image_encoder.neck.0."),
    (re.compile(r"^image_encoder\.neck_ln1\."), "image_encoder.neck.1."),
    (re.compile(r"^image_encoder\.neck_conv2\."), "image_encoder.neck.2."),
    (re.compile(r"^image_encoder\.neck_ln2\."), "image_encoder.neck.3."),
    (re.compile(r"^prompt_encoder\.point_embeddings_(\d)\."), r"prompt_encoder.point_embeddings.\1."),
    (re.compile(r"^prompt_encoder\.md_conv1\."), "prompt_encoder.mask_downscaling.0."),
    (re.compile(r"^prompt_encoder\.md_ln1\."), "prompt_encoder.mask_downscaling.1."),
    (re.compile(r"^prompt_encoder\.md_conv2\."), "prompt_encoder.mask_downscaling.3."),
    (re.compile(r"^prompt_encoder\.md_ln2\."), "prompt_encoder.mask_downscaling.4."),
    (re.compile(r"^prompt_encoder\.md_conv3\."), "prompt_encoder.mask_downscaling.6."),
    (re.compile(r"^mask_decoder\.layers_(\d+)\.mlp_lin(\d)\."), r"mask_decoder.transformer.layers.\1.mlp.lin\2."),
    (re.compile(r"^mask_decoder\.layers_(\d+)\."), r"mask_decoder.transformer.layers.\1."),
    (re.compile(r"^mask_decoder\.(final_attn_token_to_image|norm_final_attn)\."), r"mask_decoder.transformer.\1."),
    (re.compile(r"^mask_decoder\.up1\."), "mask_decoder.output_upscaling.0."),
    (re.compile(r"^mask_decoder\.up_ln\."), "mask_decoder.output_upscaling.1."),
    (re.compile(r"^mask_decoder\.up2\."), "mask_decoder.output_upscaling.3."),
    (re.compile(r"^mask_decoder\.hyper_(\d)\.layers_(\d)\."), r"mask_decoder.output_hypernetworks_mlps.\1.layers.\2."),
    (re.compile(r"^mask_decoder\.iou_head\.layers_(\d)\."), r"mask_decoder.iou_prediction_head.layers.\1."),
]
_SAM_TOKENS = ("iou_token", "mask_tokens")      # direct flax parameters, nn.Embedding weights in torch


def sam_flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
    """A leaf's flax path in the JAX package's SAM variables → segment-anything's key."""
    *mods, leaf = path
    if leaf in _SAM_TOKENS:
        mods, leaf = mods + [leaf], "weight"
    key = ".".join(mods) + "."
    for pattern, repl in _SAM_EXPORT:
        key = pattern.sub(repl, key)
    return key + {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)


def export_sam_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """The JAX package's SAM variables (``params``) → a segment-anything state dict
    of numpy arrays, the inverse of its ``convert_sam_state_dict``: Dense kernels
    ``(in, out)`` → ``(out, in)``, conv kernels HWIO → OIHW, the ``ConvTranspose``
    kernels of the upscaling flipped back spatially and laid out ``(I, O, kh, kw)``
    (flax's ConvTranspose cross-correlates the dilated input where torch's
    convolves), LayerNorm ``scale`` → ``weight``, the tokens as embedding weights."""
    out: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(variables["params"]).items():
        a = np.asarray(arr)
        if path[-1] == "kernel":
            if a.ndim == 4 and path[-2] in ("up1", "up2"):
                a = np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1))
            elif a.ndim == 4:
                a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
            else:
                a = np.ascontiguousarray(a.T)
        out[sam_flax_path_to_torch_key(path)] = a
    return out


def resize_sam_pos_embed(arr: np.ndarray, target_shape) -> np.ndarray:
    """(1, g0, g0, C) → (1, g, g, C), bicubic (the ViT convention), as the JAX
    package's ``_sam_resize_pos_embed`` loads a 1024² checkpoint at another size."""
    import torch.nn.functional as F

    t = torch.from_numpy(np.asarray(arr, np.float32)).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=tuple(target_shape[1:3]), mode="bicubic", align_corners=False)
    return t.permute(0, 2, 3, 1).numpy()


def resize_sam_rel_pos(arr: np.ndarray, target_len: int) -> np.ndarray:
    """(L0, hd) → (L, hd), linear: segment-anything's ``get_rel_pos`` rescale, as
    the JAX package's ``_sam_resize_rel_pos``."""
    import torch.nn.functional as F

    t = torch.from_numpy(np.asarray(arr, np.float32))
    t = F.interpolate(t.reshape(1, t.shape[0], -1).permute(0, 2, 1), size=target_len, mode="linear")
    return t.reshape(-1, target_len).permute(1, 0).numpy()


def load_sam_state_dict(model: torch.nn.Module, sd: Mapping[str, Any]) -> None:
    """Load a segment-anything state dict (a released ``sam_vit_*.pth``, or
    ``export_sam_state_dict``'s output) into the port's ``SAM``, strictly: every
    key present and used.  A ``pos_embed`` or rel-pos table of another size (a
    1024² checkpoint in a model of another ``img_size``) is interpolated; any
    other shape that differs raises."""
    own = model.state_dict()
    tensors = {}
    for key, value in sd.items():
        a = np.asarray(value.detach().cpu().float() if isinstance(value, torch.Tensor) else value, np.float32)
        want = tuple(own[key].shape) if key in own else a.shape
        if a.shape != want and key.endswith("pos_embed"):
            a = resize_sam_pos_embed(a, want)
        elif a.shape != want and key.endswith(("rel_pos_h", "rel_pos_w")):
            a = resize_sam_rel_pos(a, want[0])
        tensors[key] = torch.from_numpy(np.ascontiguousarray(a))
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    if missing or unexpected:
        raise ValueError(f"state dict does not fit SAM: missing {missing[:8]}, unexpected {list(unexpected)[:8]}")
