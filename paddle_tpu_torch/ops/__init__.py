"""Ops of the port: paged attention (kernel B4) and rotary embeddings."""
