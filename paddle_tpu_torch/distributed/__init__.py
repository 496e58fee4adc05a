"""Distributed pieces of the port.  Only the launch KV store
(``launch/master.py``) is ported so far; nothing here imports
``torch.distributed`` at import time."""
