"""Operators of the port: paged serving attention and the Hopper kernels
under ``hopper/``."""
