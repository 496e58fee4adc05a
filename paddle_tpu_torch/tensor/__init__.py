"""Tensor ops of the port: ``search.top_p_sampling``."""
