"""Model zoo of the port (GPT in this slice)."""

from .gpt import (PRESETS, GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  gpt_config, llama_config)
