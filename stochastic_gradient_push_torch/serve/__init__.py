"""Serving: paged-KV decode engine, continuous batching, synthetic bench."""
