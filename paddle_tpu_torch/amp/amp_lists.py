"""AMP op lists — a copy of ``paddle_tpu/amp/amp_lists.py``.

White list: ops bound by matrix products, run in float16/bfloat16.  Black
list: numerically sensitive ops, kept in float32.  The names are the
reference's ``op_name`` tags (``paddle_tpu/ops/dispatch.py``); the port,
which has no dispatch layer, tags its own counterpart of each op with the
same name (``auto_cast.amp_cast``).
"""

WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "einsum", "bmm", "mm", "addmm",
    "flash_attention", "sdpa", "lstm", "gru", "rnn_tanh", "rnn_relu",
}

BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "prod",
    "cosine_similarity", "cross_entropy", "nll_loss", "binary_cross_entropy",
    "bce_with_logits", "kl_div", "softmax_with_cross_entropy", "logsumexp",
    "cumsum", "norm", "var", "std", "renorm", "erfinv", "pow", "rsqrt",
    "layer_norm", "group_norm", "instance_norm", "rms_norm", "batch_norm",
    "ctc_loss", "sigmoid_focal_loss", "l1_loss", "smooth_l1_loss", "mse_loss",
}
