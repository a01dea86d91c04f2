"""Model zoo of the port: GPT here; the CTR models in
``models.widedeep``."""

from .gpt import (PRESETS, GPTConfig, GPTForCausalLM,  # noqa: F401
                  GPTFusedPretrainingCriterion, GPTGreedyDecoder, GPTModel,
                  GPTPretrainingCriterion, gpt_config, llama_config)
