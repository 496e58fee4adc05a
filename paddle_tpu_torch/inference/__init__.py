"""Inference of the port: the ``Config``/``Predictor`` surface with
weight-only int8 (``predictor.py``, re-exported here), the paged
continuous-batching ``ServingEngine`` (``serving.py``) and its failpoint
registry (``faults.py``, copied from paddle_tpu so this package never
imports the JAX one)."""
from .predictor import (  # noqa: F401
    Config,
    Int8Linear,
    Predictor,
    PredictorPool,
    create_predictor,
)
