"""Functional layers over dicts of tensors: quantized linears, norms,
embeddings, GQA attention with paged caches, and layer stacks."""
