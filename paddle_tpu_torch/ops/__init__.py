"""Ops of the port: flash attention (kernels B1-B3), paged attention
(kernel B4), the fused vocab loss and rotary embeddings."""
