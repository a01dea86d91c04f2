"""Serving: the continuous-batching LLM engine, its HTTP front and the
KV-page wire format."""

from .llm import (AdmissionShed, AdmissionTimeout, EngineClosed,  # noqa: F401
                  LLMEngine, OverloadShed, RequestCancelled, serve_llm)
