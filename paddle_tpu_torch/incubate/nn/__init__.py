"""The port of ``paddle_tpu.incubate.nn``: its fused functional APIs
(``functional``)."""
