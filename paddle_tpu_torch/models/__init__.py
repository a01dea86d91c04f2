"""Model zoo of the port (GPT in this slice)."""

from .gpt import (PRESETS, GPTConfig, GPTForCausalLM,  # noqa: F401
                  GPTFusedPretrainingCriterion, GPTGreedyDecoder, GPTModel,
                  GPTPretrainingCriterion, gpt_config, llama_config)
