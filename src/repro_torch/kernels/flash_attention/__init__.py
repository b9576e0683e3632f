"""K6: blocked causal GQA flash attention (train / prefill)."""
