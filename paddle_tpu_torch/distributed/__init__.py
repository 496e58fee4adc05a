"""Distributed pieces of the port: the launch KV store
(``launch/master.py``) and the user RPC over HTTP (``rpc``), both host-side
stdlib; nothing here imports ``torch.distributed`` at import time."""
from . import rpc  # noqa: F401
