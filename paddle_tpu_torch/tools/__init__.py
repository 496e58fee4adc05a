"""Command-line entries of the port: the serving fleet's worker bootstrap
(``serving_worker``) and the fleet chaos soaks (``chaos_serving``).  Run
them as modules (``python -m paddle_tpu_torch.tools.serving_worker``);
this package imports nothing on its own."""
