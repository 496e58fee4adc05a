"""Serving of the port: the paged continuous-batching ``ServingEngine``
(``serving.py``) and its failpoint registry (``faults.py``, copied from
paddle_tpu so this package never imports the JAX one)."""
