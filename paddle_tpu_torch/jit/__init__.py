"""The port's counterpart of ``paddle_tpu/jit/``: ``to_static`` over CUDA
graphs with graph-break detection (``api.py``, ``lazy_segments.py``),
``save`` / ``load`` over ``torch.export`` (``serialization.py``),
``TrainStep``, and the CUDA graph cache over device loops (``graphs.py``)
that takes the place of the reference's compiled programs."""
from . import trace_state  # noqa: F401
from .api import (  # noqa: F401
    InputSpec,
    StaticFunction,
    TrainStep,
    ignore_module,
    not_to_static,
    to_static,
)
from .serialization import LoadedLayer, load, save  # noqa: F401
from .serialization import LoadedLayer as TranslatedLayer  # noqa: F401

__all__ = ["to_static", "not_to_static", "StaticFunction", "ignore_module",
           "TrainStep", "InputSpec", "save", "load", "LoadedLayer",
           "TranslatedLayer", "enable_to_static", "set_code_level",
           "set_verbosity"]


def enable_to_static(flag: bool = True):
    """Globally toggle to_static (parity: jit.enable_to_static).  When off,
    ``StaticFunction`` calls run their function as it is."""
    from . import api

    api._to_static_enabled = bool(flag)


def set_code_level(level=100, also_to_stdout=False):
    pass  # dy2static transformed-code dumping: no AST transform stage exists


def set_verbosity(level=0, also_to_stdout=False):
    pass
