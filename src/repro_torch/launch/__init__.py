"""Launchers of the LLM stack: the prefill and decode step factories and the
continuous-batching serve loop."""
