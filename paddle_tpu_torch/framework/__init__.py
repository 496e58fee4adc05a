"""Framework pieces of the port: seeded random keys (``random``)."""
