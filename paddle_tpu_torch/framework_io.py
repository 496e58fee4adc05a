"""``save`` / ``load`` — the port of ``paddle_tpu/framework_io.py``
(``:1-58``), in the reference's layout, so a file moves between the two
packages.

A file is a pickle of the nested object whose tensor leaves are tagged
numpy payloads, ``{"__paddle_tpu_tensor__": True, "data": <numpy>,
"stop_gradient", "name", "is_parameter"}``.  A bfloat16 tensor cannot be a
numpy array without ``ml_dtypes`` (which the card's machine lacks): it is
written as its exact float32 values with ``"dtype": "bfloat16"`` added,
and read back as bfloat16; the reference reads that leaf as float32.  A
bfloat16 payload the reference wrote (an ``ml_dtypes`` array) is read
through float32, exactly.  ``load`` returns CPU tensors (``nn.Parameter``
for a leaf saved as a parameter), or the numpy payloads under
``return_numpy=True``.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load"]

_TAG = "__paddle_tpu_tensor__"


def _pack(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        leaf = {_TAG: True, "stop_gradient": not obj.requires_grad,
                "name": None,
                "is_parameter": isinstance(obj, torch.nn.Parameter)}
        if t.dtype == torch.bfloat16:
            leaf.update(data=t.float().numpy(), dtype="bfloat16")
        else:
            leaf["data"] = t.numpy()
        return leaf
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _leaf(obj: dict) -> torch.Tensor:
    data = np.asarray(obj["data"])
    if data.dtype.name == "bfloat16":
        t = torch.from_numpy(data.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(data))
        if obj.get("dtype") == "bfloat16":
            t = t.to(torch.bfloat16)
    if obj.get("is_parameter", False):
        return torch.nn.Parameter(
            t, requires_grad=not obj.get("stop_gradient", True))
    return t


def _unpack(obj: Any, return_numpy: bool = False) -> Any:
    if isinstance(obj, dict):
        if obj.get(_TAG):
            return obj["data"] if return_numpy else _leaf(obj)
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path: str, return_numpy: bool = False, **configs) -> Any:
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _unpack(obj, return_numpy)
