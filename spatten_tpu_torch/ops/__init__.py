"""Compute ops: RoPE, KV quantization, reference and prefill attention, and
the two kernel wrappers (K1 ``fused_decode``, K2 ``compact_gather``)."""
