"""Host-side data: packet batching, synthetic LM batches, a prefetcher."""
from repro_torch.data.pipeline import Prefetcher, lm_batches, phv_batches  # noqa: F401
