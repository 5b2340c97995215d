"""Multi-sequence batching and batched fusion on one card."""
