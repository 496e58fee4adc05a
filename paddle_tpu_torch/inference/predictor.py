"""Inference predictor — the port of ``paddle_tpu/inference/__init__.py``'s
``Config``/``Predictor`` surface (paddle's ``create_predictor`` API).

A ``Predictor`` serves a live layer (``Config.set_layer``) or a saved
artifact (``Config(model_path)``, the path ``jit.save`` wrote).

A live layer runs under ``torch.no_grad()`` in ``eval()`` on the device of
the layer's parameters, with the inputs moved there, and hands the outputs
back as numpy.  With ``Config.enable_weight_only_quant("int8")`` it first
rewrites a deep copy of the layer (the caller's layer is left untouched),
swapping every ``nn.Linear`` for an ``Int8Linear`` whose product is kernel
B7 (``quantization.weight_only_linear``).  ``ParallelLinear`` (Llama's
projections) is not a ``Linear`` and is left as it is, as the reference's
rewrite leaves its mp layers.

An artifact runs its exported program (``jit.load``: a ``torch.export``
program whose kernels are the port's custom ops) on the device it was
exported on.  ``get_input_names`` reads its input spec (``x0``, ``x1``,
...); ``enable_weight_only_quant`` has no effect on it and warns, as the
reference's (the weights are in the program: save an int8-rewritten layer
instead); ``enable_batch_padding`` pads dim 0 of each input with zeros up
to the exported batch (``_pad_batch``; a larger batch raises
``ValueError``) and slices the outputs back to the real batch.  A missing
artifact raises ``FileNotFoundError`` on its ``.pdmodel.json``.

The reference keeps one ``jax.jit`` per input signature, keyed
``tuple((shape, dtype))``.  On CUDA each ``Predictor`` owns a
``jit.graphs.GraphCache`` (its own memory pool; a ``PredictorPool``'s
predictors each have theirs) under the same key: a signature's first run
is eager, then the layer's forward (or the artifact's program) is
captured into a CUDA graph; later runs copy the inputs into the graph's
static buffers (numpy and CPU tensors through pinned staging, device
tensors device to device), replay, and copy the outputs to numpy, the
run's one wait.  The handles API takes the same route.  The cache is
unbounded, as the reference's.  The graphs read the parameters in place:
a parameter or buffer replaced by another tensor (``Module.to``,
``load_state_dict(..., assign=True)``) drops them at the next run
(``GraphCache.watch``), and they are captured again; a submodule swapped
in after the predictor was made is not seen (the reference's compiled
programs keep the weights of their first run).  A layer or artifact on
the CPU runs eagerly; the private ``_graphs = False`` runs it eagerly on
CUDA too (the tests and ``chip_smoke.py``).
"""
from __future__ import annotations

import copy
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..jit.graphs import GraphCache, module_tensors
from ..nn import Linear, _tensor_from_numpy
from ..ops.hopper import launch_counters
from ..quantization import weight_only_linear, weight_quantize

__all__ = ["Config", "create_predictor", "Predictor", "PredictorPool",
           "Int8Linear"]


class Config:
    """paddle.inference.Config: a live layer (``set_layer``) or the
    ``jit.save`` path of an artifact (``model_path``; ``params_path`` kept
    for parity)."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        self.model_path = model_path
        self.params_path = params_path
        self._weight_only = None
        self._memory_optim = True
        self._ir_optim = True
        self._layer = None
        self._batch_pad = False

    # capability toggles, kept for API parity (PyTorch owns these)
    def enable_memory_optim(self, flag=True):
        self._memory_optim = flag

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def set_cpu_math_library_num_threads(self, n):
        pass

    def disable_glog_info(self):
        pass

    def enable_use_gpu(self, *a, **k):
        pass  # the layer's parameters decide the device

    def enable_xpu(self, *a, **k):
        pass

    def enable_weight_only_quant(self, dtype="int8"):
        if dtype != "int8":
            raise NotImplementedError("weight-only quant supports int8")
        self._weight_only = dtype

    def enable_batch_padding(self, flag=True):
        """Pad smaller batches up to an artifact's exported batch instead of
        failing on them.  Only a predictor over an artifact reads it, as in
        the reference: on a live layer it has no effect."""
        self._batch_pad = flag

    def set_layer(self, layer: nn.Module):
        """Serve a live layer."""
        self._layer = layer


class _Handle:
    """Input/output tensor handle (ZeroCopyTensor analog)."""

    def __init__(self, name):
        self.name = name
        self._val = None

    def copy_from_cpu(self, arr):
        self._val = np.asarray(arr)

    def reshape(self, shape):
        pass  # the shape comes from the array itself

    def copy_to_cpu(self):
        return np.asarray(self._val)

    def share_external_data(self, arr):
        self.copy_from_cpu(arr)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()      # exact widening: numpy has no bfloat16
    return t.numpy()


def _flatten(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    return [t for o in out for t in _flatten(o)]


class Predictor:
    """Runs ``config``'s layer on numpy inputs, through ``run(inputs)`` or
    the handles API.  Outputs come back as numpy in the layer's output
    dtype, except bfloat16, which comes back as float32 (numpy has no
    bfloat16; the widening is exact)."""

    def __init__(self, config: Config):
        self.config = config
        self._layer = config._layer
        self._loaded = None
        self._input_names: List[str] = []
        if config.model_path and self._layer is None:
            from ..jit.serialization import load as jit_load

            self._loaded = jit_load(config.model_path)
            if config._weight_only is not None:
                warnings.warn(
                    "enable_weight_only_quant has no effect on a saved "
                    "artifact (weights are baked into the compiled program); "
                    "build the predictor from a live Layer via "
                    "config.set_layer() to serve int8 weights")
            spec = self._loaded.meta.get("input_spec") or []
            self._input_names = [f"x{i}" for i in range(len(spec))]
            self._device = self._loaded.device
            weights = self._loaded.module or torch.nn.Module()
        elif self._layer is None:
            raise ValueError("Predictor: the config holds no layer; call "
                             "config.set_layer(layer)")
        else:
            if config._weight_only == "int8":
                self._layer = _rewrite_weight_only_int8(self._layer)
            # a layer with neither parameters nor buffers runs on the card
            # (resolve_device raises without CUDA: there is no quiet CPU run)
            first = next(iter(self._layer.parameters()),
                         next(iter(self._layer.buffers()), None))
            self._device = (first.device if first is not None
                            else resolve_device(None))
            weights = self._layer
        self._inputs: Dict[str, _Handle] = {}
        self._outputs: List[np.ndarray] = []
        self._graphs = self._device.type == "cuda"
        self._graph_cache = GraphCache(self._device, counters=launch_counters,
                                       weights=module_tensors(weights))

    # ----------------------------------------------------------- handles API
    def get_input_names(self):
        return self._input_names or sorted(self._inputs)

    def get_input_handle(self, name):
        h = self._inputs.get(name)
        if h is None:
            h = self._inputs[name] = _Handle(name)
            if name not in self._input_names:
                self._input_names.append(name)
        return h

    def get_output_names(self):
        return [f"out{i}" for i in range(len(self._outputs))]

    def get_output_handle(self, name):
        i = int(name.replace("out", ""))
        h = _Handle(name)
        h._val = self._outputs[i]
        return h

    # ----------------------------------------------------------------- run
    def run(self, inputs: Optional[List[np.ndarray]] = None
            ) -> List[np.ndarray]:
        if inputs is None:
            inputs = [self._inputs[n]._val for n in self._input_names]
        vals = [v if isinstance(v, torch.Tensor)
                else _tensor_from_numpy(np.asarray(v)) for v in inputs]
        real_n = None
        if self._loaded is not None:
            forward = self._loaded.forward_flat
            spec = self._loaded.meta.get("input_spec") or []
            if self.config._batch_pad and spec:
                vals, real_n = _pad_batch(vals, spec)
        else:
            layer = self._layer

            def forward(*xs):
                layer.eval()
                return _flatten(layer(*xs))

        with torch.no_grad():
            if self._graphs:
                cache = self._graph_cache
                cache.watch()
                key = tuple((tuple(v.shape), v.dtype) for v in vals)
                outs = cache.run(key, forward, vals)
            else:
                outs = forward(*[v.to(self._device) for v in vals])
        self._outputs = [_to_numpy(o)[:real_n] for o in outs]
        return self._outputs


def _pad_batch(vals: List[torch.Tensor], spec):
    """Pad dim 0 of each input with zeros up to the artifact's batch
    (``spec[i]["shape"][0]``, 1 when unknown); return (padded, real batch).
    A larger batch raises ``ValueError``."""
    real_n = int(vals[0].shape[0])
    out = []
    for v, sm in zip(vals, spec):
        want = sm["shape"][0] or 1
        if v.shape[0] < want:
            pad = v.new_zeros((want - v.shape[0], *v.shape[1:]))
            v = torch.cat([v, pad])
        elif v.shape[0] > want:
            raise ValueError(f"batch {v.shape[0]} exceeds compiled batch "
                             f"{want}")
        out.append(v)
    return out, real_n


class Int8Linear(nn.Module):
    """A ``Linear`` with int8 storage: ``qweight`` [in, out] int8 and
    ``scale`` [out] float32 (buffers, from ``weight_quantize`` of the
    Linear's weight on its device) and the Linear's own ``bias``."""

    def __init__(self, lin: Linear):
        super().__init__()
        qweight, scale = weight_quantize(lin.weight)
        self.register_buffer("qweight", qweight)
        self.register_buffer("scale", scale)
        self.bias = lin.bias

    def forward(self, x):
        return weight_only_linear(x, self.qweight, self.bias, self.scale)


def _rewrite_weight_only_int8(layer: nn.Module) -> nn.Module:
    """A deep copy of ``layer`` with every ``Linear`` swapped for an
    ``Int8Linear``."""
    layer = copy.deepcopy(layer)

    def rewrite(parent):
        for name, sub in list(parent._modules.items()):
            if isinstance(sub, Linear):
                setattr(parent, name, Int8Linear(sub))
            elif sub is not None:
                rewrite(sub)

    rewrite(layer)
    return layer


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


class PredictorPool:
    """paddle_infer.PredictorPool — ``size`` predictors over one config."""

    def __init__(self, config: Config, size: int = 1):
        self._preds = [Predictor(config) for _ in range(size)]

    def retrieve(self, idx: int) -> Predictor:
        return self._preds[idx]
