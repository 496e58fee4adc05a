"""Model definitions of the port: the Llama and GPT families and
generation over them, the names of ``paddle_tpu.models`` (but the
pipeline-parallel ``*_pipeline_descs``, ROADMAP A8)."""
from .generation import generate, greedy_decode  # noqa: F401
from .gpt import (  # noqa: F401
    GPTConfig,
    GPTForCausalLM,
    GPTModel,
    GPTPretrainingCriterion,
    gpt3_1_3b,
    gpt_tiny,
)
from .llama import (  # noqa: F401
    LlamaConfig,
    LlamaForCausalLM,
    LlamaModel,
    LlamaPretrainingCriterion,
    llama_7b,
    llama_tiny,
)
