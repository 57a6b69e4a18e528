"""Ops of the port (counterpart of thyroid_tpu/ops); the per-window
attention is re-exported here, as the JAX package does."""
from .attention import fused_window_attention, window_attention_reference  # noqa: F401
