"""``jit.save`` / ``jit.load`` — the port of
``paddle_tpu/jit/serialization.py``.

The files beside ``path``:

- ``<path>.pdiparams.npz``: the layer's ``state_dict`` as numpy, under the
  reference's keys; a bfloat16 tensor as its exact float32 values (numpy
  has no bfloat16), the dtype kept in the meta (``framework_io.py``'s
  rule);
- ``<path>.pdmodel.json``: the reference's meta (``format_version``,
  ``layer_class``, ``params`` {name: {shape, dtype}}, ``input_spec``) and
  the port's ``device``, the device the program was exported on, and,
  where the export failed, ``export_error`` (the parameters are saved all
  the same);
- ``<path>.pt2``, in place of the reference's ``.stablehlo`` /
  ``.jaxexport``, where ``input_spec`` is given:
  ``torch.export.export(layer, example_inputs, strict=False)`` of the
  layer's forward in eval mode under ``torch.no_grad``, each dynamic dim
  exported at 1, as the reference's (``:75``).

The Hopper kernels on the path are ``torch.library`` custom ops
(``ops/hopper``): the export traces them through their fake
implementations (shapes only), so it reads no address and launches
nothing, and the program calls the kernels when it runs.  A program runs
on the device it was exported on: ``load`` of a CUDA artifact where there
is no CUDA raises ``RuntimeError``, never a quiet run on the CPU.
``LoadedLayer.set_onto(layer)`` copies the saved state into a layer of the
same structure, so a port model takes what the reference's ``jit.save``
wrote, and the reference what the port's wrote.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

__all__ = ["save", "load", "LoadedLayer"]


def _dtype_name(dtype) -> str:
    """A dtype's name as the meta writes it ("float32", "int32", ...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)


def _spec_meta(input_spec):
    from .api import InputSpec

    out = []
    for s in input_spec:
        if isinstance(s, InputSpec):
            out.append({"shape": s.shape, "dtype": _dtype_name(s.dtype)})
        else:
            out.append({"shape": list(s.shape),
                        "dtype": _dtype_name(s.dtype)})
    return out


def _layer_device(layer: torch.nn.Module) -> torch.device:
    from ..device import resolve_device

    for t in list(layer.parameters()) + list(layer.buffers()):
        return t.device
    return resolve_device(None)


def _export(layer, spec_meta, device):
    """The eval-mode, no-grad forward of ``layer`` exported at the spec's
    shapes (a dynamic dim at 1)."""
    example = tuple(
        torch.zeros([1 if d in (None, -1) else int(d) for d in sm["shape"]],
                    dtype=getattr(torch, sm["dtype"]), device=device)
        for sm in spec_meta)
    was_training = layer.training
    layer.eval()
    try:
        with torch.no_grad():
            return torch.export.export(layer, example, strict=False)
    finally:
        layer.train(was_training)


def save(layer, path: str, input_spec=None, **configs):
    """Write ``layer``'s (or a ``to_static`` layer's) parameters, meta and,
    with ``input_spec``, its exported program (module docstring)."""
    from .api import StaticFunction

    if isinstance(layer, StaticFunction):
        layer = layer._layer
    if not isinstance(layer, torch.nn.Module):
        raise TypeError("jit.save expects a Layer or to_static-wrapped Layer")

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    device = _layer_device(layer)
    arrays, dtypes = {}, {}
    for k, v in layer.state_dict().items():
        t = v.detach().cpu()
        dtypes[k] = _dtype_name(t.dtype)
        arrays[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    np.savez(path + ".pdiparams.npz", **arrays)

    meta = {
        "format_version": 1,
        "layer_class": type(layer).__name__,
        "params": {k: {"shape": list(a.shape), "dtype": dtypes[k]}
                   for k, a in arrays.items()},
        "input_spec": None,
        "device": str(device),
    }
    if input_spec:
        meta["input_spec"] = _spec_meta(input_spec)
        try:
            program = _export(layer, meta["input_spec"], device)
            torch.export.save(program, path + ".pt2")
        except Exception as e:  # export is best-effort; params always saved
            meta["export_error"] = f"{type(e).__name__}: {e}"

    with open(path + ".pdmodel.json", "w") as f:
        json.dump(meta, f, indent=1)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A saved array as a CPU tensor of its recorded dtype: bfloat16 from
    the port's float32 values or from the reference's 2-byte elements
    (read by their bits)."""
    if dtype != "bfloat16":
        return torch.from_numpy(np.array(a, copy=True))
    if a.dtype.itemsize == 2:
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


class LoadedLayer:
    """The callable ``jit.load`` restores.  With a ``.pt2`` program (an
    ``input_spec`` at save), a call runs it on the device it was exported
    on, under ``torch.no_grad``: positional inputs (tensors or numpy
    arrays), the outputs as one tensor or a list of them."""

    def __init__(self, path: str):
        self._path = path
        with open(path + ".pdmodel.json") as f:
            self.meta = json.load(f)
        self._arrays = dict(np.load(path + ".pdiparams.npz"))
        self.device = torch.device(self.meta.get("device", "cpu"))
        self.program = None
        self.module = None
        if os.path.exists(path + ".pt2"):
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"jit.load({path!r}): the program was exported on "
                    f"{self.device} and runs there, and no CUDA device is "
                    "available; save it from a layer on device='cpu' to run "
                    "it on the CPU")
            from ..ops import hopper  # noqa: F401  (registers the kernels)

            self.program = torch.export.load(path + ".pt2")
            self.module = self.program.module()

    def state_dict(self) -> Dict[str, torch.Tensor]:
        params = self.meta["params"]
        return {k: _from_numpy(v, params.get(k, {}).get("dtype", ""))
                for k, v in self._arrays.items()}

    def set_onto(self, layer: torch.nn.Module) -> torch.nn.Module:
        """Copy the saved state into ``layer`` (its parameters and
        persistent buffers, each in its own dtype and device).  Raises
        ``KeyError`` on a missing or extra name and ``ValueError`` on a
        shape mismatch, before copying anything."""
        sd = self.state_dict()
        own = layer.state_dict(keep_vars=True)
        missing, extra = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
        if missing or extra:
            raise KeyError(f"state_dict mismatch: missing {missing}, "
                           f"unexpected {extra}")
        for k, t in own.items():
            if tuple(sd[k].shape) != tuple(t.shape):
                raise ValueError(f"{k}: shape {tuple(sd[k].shape)} does not "
                                 f"match the layer's {tuple(t.shape)}")
        with torch.no_grad():
            for k, t in own.items():
                t.copy_(sd[k])
        return layer

    def forward_flat(self, *args) -> list:
        """The program on ``args`` (on its device) -> its outputs as a
        flat list of tensors."""
        if self.module is None:
            raise RuntimeError(
                "This artifact was saved without input_spec, so no compiled "
                "forward was exported. Rebuild the model class and call "
                "loaded.set_onto(model).")
        xs = [a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a)) for a in args]
        with torch.no_grad():
            out = self.module(*[x.to(self.device) for x in xs])
        from .api import flatten_tensors

        return flatten_tensors(out)[0]

    def __call__(self, *args, **kwargs):
        outs = self.forward_flat(*args)
        return outs if len(outs) > 1 else outs[0]


def load(path: str, **configs) -> LoadedLayer:
    return LoadedLayer(path)
