"""Ops of the port: flash attention (kernels B1-B3), paged attention
(kernel B4), the fused vocab loss and rotary embeddings.

As in the JAX package, the paged-attention entry points are exported
here, and ``paddle_tpu_torch.ops.paged_attention`` is then the function
of that name; reach the module with ``importlib.import_module(
"paddle_tpu_torch.ops.paged_attention")``."""

from .paged_attention import (PagedKVCache, QuantizedKV,  # noqa: F401
                              paged_attention, paged_attention_chunk,
                              paged_attention_ragged,
                              ragged_paged_attention,
                              ragged_paged_attention_reference)
