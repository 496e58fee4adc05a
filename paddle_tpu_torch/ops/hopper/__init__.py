"""Hand-written Hopper (sm_90a) kernels, one module per kernel source in
``paddle_tpu_torch/csrc/``, mirroring ``paddle_tpu/ops/pallas/``.  Each
module keeps the kernel's plain PyTorch version beside its wrapper."""
