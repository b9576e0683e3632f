"""K5: one-token GQA decode attention over a KV cache (FlashDecoding)."""
