"""Read and write the JAX package's checkpoints; turn them into the port's
weights.

A checkpoint is ``UTPUCKPT1\\n`` followed by one msgpack map
``{"config": {...}, "params": pytree}`` as flax's ``msgpack_serialize``
writes it: arrays are msgpack ext type 1 holding a packed
``(shape, dtype_name, bytes)`` tuple.  Neither msgpack nor flax is needed:
:func:`unpackb` reads and :func:`packb` writes the subset of msgpack these
files use, so a file :func:`save` writes loads in the JAX package's
``checkpoint.load`` and the other way round.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models.import_torch import convert_state_dict

MAGIC = b"UTPUCKPT1\n"
_EXT_NDARRAY = 1  # flax.serialization._MsgpackExtType.ndarray


class _Reader:
    """Decoder for maps, arrays, str/bin, ints, floats, bools, nil and ext
    type 1 (flax's ndarray)."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        t = self._take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return str(self._take(t & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {  # code -> (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if t in sized:
            fmt, kind = sized[t]
            n = self._unpack(fmt)
            if kind == "bin":
                return bytes(self._take(n))
            if kind == "str":
                return str(self._take(n), "utf-8")
            if kind == "array":
                return self._array(n)
            if kind == "map":
                return self._map(n)
            return self._ext(n)
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self._unpack(scalars[t])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self._ext(fixext[t])
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, n: int) -> np.ndarray:
        code = self._unpack(">b")
        data = bytes(self._take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, raw = unpackb(data)
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        try:
            dtype = np.dtype(dtype_name)
        except TypeError:
            raise ValueError(f"unsupported array dtype {dtype_name!r}") from None
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """Decode one msgpack value that spans all of ``data``."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after msgpack value")
    return out


def _pack(v: Any, out: list) -> None:
    """Append the msgpack encoding of ``v`` to ``out`` (bytes pieces), in
    the smallest form, as msgpack-python writes it under flax."""
    def head(n: int, fix: int, fix_max: int, codes) -> None:
        if n <= fix_max:
            out.append(bytes([fix | n]))
            return
        for code, fmt in codes:
            if n < 1 << (8 * struct.calcsize(fmt)):
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack: length {n} too large")

    if isinstance(v, (np.ndarray, np.generic)):  # first: np.float64 is a float
        # a numpy scalar (the w8a8 tree's act_scale) as a 0-d array, as
        # jax.device_get leaves it for flax in the JAX package's save
        v = np.asarray(v)
        if v.dtype.hasobject or v.dtype.names:
            raise ValueError(f"msgpack: unsupported array dtype {v.dtype}")
        data = packb([list(v.shape), v.dtype.name, v.tobytes("C")])
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixext:
            out.append(bytes([fixext[len(data)]]))
        else:
            head(len(data), 0, -1, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
        out.append(struct.pack(">b", _EXT_NDARRAY))
        out.append(data)
    elif v is None or isinstance(v, bool):
        out.append({None: b"\xc0", False: b"\xc2", True: b"\xc3"}[v])
    elif isinstance(v, int):
        if 0 <= v <= 0x7F or -32 <= v < 0:
            out.append(struct.pack(">b" if v < 0 else ">B", v))
        elif v >= 0:
            for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                              (0xCF, ">Q")):
                if v < 1 << (8 * struct.calcsize(fmt)):
                    out.append(bytes([code]) + struct.pack(fmt, v))
                    return
            raise ValueError(f"msgpack: int {v} too large")
        else:
            for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                              (0xD3, ">q")):
                if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    out.append(bytes([code]) + struct.pack(fmt, v))
                    return
            raise ValueError(f"msgpack: int {v} too small")
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        data = v.encode("utf-8")
        head(len(data), 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
        out.append(data)
    elif isinstance(v, bytes):
        head(len(v), 0, -1, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
        out.append(v)
    elif isinstance(v, (list, tuple)):
        head(len(v), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I")))
        for item in v:
            _pack(item, out)
    elif isinstance(v, dict):  # keys sorted, as flax's tree_map leaves them
        head(len(v), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I")))
        for k in sorted(v):
            _pack(k, out)
            _pack(v[k], out)
    else:
        raise TypeError(f"msgpack: cannot encode {type(v).__name__}")


def packb(value: Any) -> bytes:
    """Encode one value: dicts, lists and tuples, str, bytes, ints,
    floats, bools, None, and numpy arrays and scalars as flax's ext type 1
    (a scalar as a 0-d array)."""
    out: list = []
    _pack(value, out)
    return b"".join(out)


def save(path: str, params: dict, cfg: ModelConfig) -> None:
    """Write ``params`` (a pytree of numpy arrays, as :func:`load` returns
    and ``models.registry.init`` builds) and ``cfg`` to ``path`` in the JAX
    package's format (``unetseg_tpu/checkpoint.py::save``), byte for byte
    what flax writes.  The file appears only when complete."""
    payload = packb({"config": dataclasses.asdict(cfg), "params": params})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(payload)
    os.replace(tmp, path)


def create(path: str, cfg: ModelConfig = ModelConfig(), seed: int = 0) -> None:
    """Write a fresh He-normal checkpoint for ``cfg`` (any registered arch)
    drawn from a ``torch.Generator`` seeded with ``seed``
    (``unetseg_tpu/checkpoint.py::create``; the weights differ from JAX's
    for the same seed)."""
    from unetseg_tpu_torch.models import registry  # it imports this module

    save(path, registry.init(cfg, torch.Generator().manual_seed(seed)), cfg)


def load(path: str) -> Tuple[dict, ModelConfig]:
    """Read a checkpoint: (params pytree of numpy arrays, model config).
    Arrays keep their stored dtype."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            if magic.startswith(b"UTPUCKPT"):
                raise ValueError(
                    f"Checkpoint format version mismatch: {path} has "
                    f"{magic.strip().decode(errors='replace')!r}, this build "
                    f"reads {MAGIC.strip().decode()!r}")
            raise ValueError(f"Not a unetseg_tpu checkpoint: {path}")
        data = unpackb(f.read())
    return data["params"], config_from_snapshot(data["config"], path)


def config_from_snapshot(raw_cfg, source: str) -> ModelConfig:
    """ModelConfig from a serialized config dict; unknown (newer) fields are
    dropped with a warning."""
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    raw_cfg = dict(raw_cfg)
    extra = sorted(set(raw_cfg) - known)
    if extra:
        warnings.warn(
            f"checkpoint {source} carries unknown config fields {extra} "
            f"(written by a newer build?) — ignoring them", stacklevel=2)
    return ModelConfig(**{k: v for k, v in raw_cfg.items() if k in known})


def load_serving(models_dir: str, include_flagship: bool = True
                 ) -> Optional[Tuple[dict, ModelConfig, str]]:
    """The serving checkpoint by the shipped policy, or None:
    slim5 > slim4 specialist > slim4 robust > gen-1 slim > (optionally) the
    flagship teacher.  Returns (params, cfg, tier_name)."""
    order = [("slim5", "flagship_slim5.ckpt"),
             ("slim4", "flagship_slim4.ckpt"),
             ("slim4", "flagship_slim4_robust.ckpt"),
             ("slim", "flagship_slim.ckpt")]
    if include_flagship:
        order.append(("flagship", "flagship_synth.ckpt"))
    for name, fname in order:
        p = os.path.join(models_dir, fname)
        if os.path.exists(p):
            params, cfg = load(p)
            return params, cfg, name
    return None


def up_weight_from_hwio(w: np.ndarray) -> np.ndarray:
    """2x2 stride-2 up-conv weight, HWIO ``(2, 2, C, O)`` -> the ``(C, 4*O)``
    matmul weight laid out (c, a, b, o) for output pixel (2i+a, 2j+b).

    ``lax.conv_transpose`` without ``transpose_kernel`` computes
    ``y[2i+a, 2j+b] = x[i, j] @ w[1-a, 1-b]``: its taps are flipped against
    ``torch.conv_transpose2d``'s, so they are flipped here.
    """
    c, o = w.shape[2], w.shape[3]
    return np.asarray(w)[::-1, ::-1].transpose(2, 0, 1, 3).reshape(c, 4 * o)


def up_weight_to_hwio(m: np.ndarray) -> np.ndarray:
    """The inverse of :func:`up_weight_from_hwio`: the ``(C, 4*O)`` matmul
    weight laid out (c, a, b, o) -> HWIO ``(2, 2, C, O)``."""
    c, o = m.shape[0], m.shape[1] // 4
    return np.ascontiguousarray(
        np.asarray(m).reshape(c, 2, 2, o).transpose(1, 2, 0, 3)[::-1, ::-1])


def params_to_jax(state: Dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`params_from_jax` for the float families: the
    port's state dict (any device) -> the JAX param pytree of float32 numpy
    arrays.

    A name's last part (``weight``, ``bias``; ``head_weight`` and
    ``head_bias`` for the top-level head) picks ``w`` or ``b``; the rest is
    the site's path.  A site named ``up`` is an up-conv (its ``(C, 4*O)``
    weight back to HWIO by :func:`up_weight_to_hwio`), any other 2-D weight
    a 1x1 conv ``(1, 1, C, O)``, a 1-D weight a norm's ``scale`` (its bias
    then ``bias``); 3x3 and larger weights are HWIO already, and a per-head
    product's 3-D weight is kept.  Any other last part is an array of its
    own at that path (TransUNet's ``embed.pos``).  A node whose keys are
    all integers becomes a list, as the JAX trees hold ``encoder``,
    ``decoder``, ``backbone`` and ``heads``; UNet++'s ``nodes`` (keys
    ``"i_j"``) stay a dict."""
    tree: dict = {}
    for name, t in state.items():
        if name in ("head_weight", "head_bias"):
            path, leaf = ["head"], name[len("head_"):]
        else:
            *path, leaf = name.split(".")
        if not path:
            raise ValueError(f"params_to_jax: {name!r} is not a float "
                             f"family's weight or bias")
        a = t.detach().to("cpu", torch.float32).numpy()
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        if leaf == "weight":
            if path[-1] == "up":
                a = up_weight_to_hwio(a)
            elif a.ndim == 2:
                a = a.reshape(1, 1, *a.shape)
            node["scale" if a.ndim == 1 else "w"] = np.array(a)
        else:
            node["b" if leaf == "bias" else leaf] = np.array(a)

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if "scale" in node and "b" in node:  # a norm's shift
            node["bias"] = node.pop("b")
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(tree)


def params_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """A JAX param pytree (numpy) of any float family -> the port's state
    dict (CPU tensors, stored dtype kept).

    Every dict holding a rank-4 ``w`` is a conv site, named by its path in
    the tree (``decoder.0.att_x``, ``nodes.0_1.up``, ``heads.2``); the
    modules of ``models/`` carry the same names.  By kernel size:

    * 3x3 (and TransUNet's 7x7) convs keep HWIO ``(3, 3, C, D)``;
      contiguous, that is the ``(9*C, D)`` operand the conv kernel reads.
    * 2x2 up-convs become matmul weights (:func:`up_weight_from_hwio`).
    * 1x1 convs ``(1, 1, C, O)`` become ``(C, O)`` products.

    A conv site without ``b`` (TransUNet's ResNet, SAMed's neck) has no
    bias.  TransUNet's and SAMed's other sites: a dict holding a 2- or 3-D
    ``w`` (the attention's per-head products) keeps it as ``{path}.weight``;
    a norm ``{"scale", "bias"}`` becomes ``{path}.weight`` and
    ``{path}.bias``; an array outside any site (``embed.pos``; SAMed's
    ``rel_pos_h``, ``rel_pos_w``, ``tokens``, ``no_mask_embed``,
    ``pe_gaussian`` and ``offset``) is ``{path}``.  SAMed's 16x16 patch
    embedding keeps HWIO, its transposed convs are up-convs named ``up``.

    The top-level ``head`` of the UNet and Attention U-Net trees is the
    modules' ``head_weight`` / ``head_bias``.  A list may also come as a
    dict keyed ``"0"``, ``"1"``, ... (flax's state-dict form, in which
    ``train.save_state`` writes the optimizer's moments): the names are the
    same.  :func:`params_to_jax` is the inverse for the float families.

    A w8a8 site (``unet_w8a8``: a dict holding ``w_q``, ``w_scale``, ``b``,
    ``act_scale``; ``quantize.quantize_params``) becomes ``{path}.weight``
    (int8: a 3x3 conv K-major ``(3, 3, D, C)`` for K7, an up-conv ``(C,
    4*D)``, the head ``(C, D)``), ``{path}.scale`` = act_scale * w_scale
    (one f32 product, as JAX computes it), ``{path}.bias`` and the 0-d
    ``{path}.act_scale``; the head too is ``head.weight`` and so on.
    """
    state: Dict[str, torch.Tensor] = {}

    def w8a8_site(node, path: str) -> None:
        w = np.asarray(node["w_q"])
        if w.shape[0] == 2:
            w = up_weight_from_hwio(w)
        elif w.shape[0] == 1:
            w = w.reshape(w.shape[2], w.shape[3])
        else:
            w = w.transpose(0, 1, 3, 2)
        act = np.float32(node["act_scale"])
        site = {"weight": w,
                "scale": act * np.asarray(node["w_scale"], np.float32),
                "bias": np.asarray(node["b"], np.float32),
                "act_scale": np.asarray(act)}
        for name, a in site.items():
            state[f"{path}.{name}"] = torch.from_numpy(np.array(a))

    def walk(node, path: str) -> None:
        if isinstance(node, dict) and "w_q" in node:
            w8a8_site(node, path)
        elif isinstance(node, dict) and getattr(node.get("w"), "ndim", 0) in (
                2, 3, 4):
            w = np.asarray(node["w"])
            if w.ndim == 4 and w.shape[0] == 2:
                w = up_weight_from_hwio(w)
            elif w.ndim == 4 and w.shape[0] == 1:
                w = w.reshape(w.shape[2], w.shape[3])
            prefix = "head_" if path == "head" else path + "."
            # owned, writable copies
            state[prefix + "weight"] = torch.from_numpy(np.array(w))
            if "b" in node:
                state[prefix + "bias"] = torch.from_numpy(np.array(node["b"]))
        elif isinstance(node, dict) and getattr(node.get("scale"), "ndim",
                                                0) == 1:
            state[path + ".weight"] = torch.from_numpy(np.array(node["scale"]))
            state[path + ".bias"] = torch.from_numpy(np.array(node["bias"]))
        elif hasattr(node, "ndim"):
            state[path] = torch.from_numpy(np.array(node))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")

    walk(tree, "")
    return state


def params_from_torch_state_dict(state_dict, cfg: ModelConfig = ModelConfig()
                                 ) -> dict:
    """Weights of the canonical PyTorch UNet layout (``encoder.{i}.conv1``
    ..., ``head``; ``models/import_torch.py``) -> the JAX-layout tree as
    float32 numpy, ready for :func:`save` (``unetseg_tpu/checkpoint.py::
    params_from_torch_state_dict``)."""
    return convert_state_dict(state_dict, cfg)
