"""Host-side packet batching."""
