"""Serving: the continuous-batching LLM engine."""

from .llm import EngineClosed, LLMEngine  # noqa: F401
