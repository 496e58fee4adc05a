"""The port of ``paddle_tpu.incubate``: the fused functional APIs
(``incubate.nn.functional``) that the port has so far."""
