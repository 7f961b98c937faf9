"""The paper's data-parallel gradient sync over ``torch.distributed``:
flat and hierarchical all-reduce (C5) and compressed all-gather with error
feedback (C6, Eq. 10-11); asynchronous DP with delay compensation (C7,
Eq. 12)."""
from repro_torch.core.async_dp import (AsyncConfig, simulate_async_sgd,
                                       simulate_sync_sgd)

__all__ = ["AsyncConfig", "simulate_async_sgd", "simulate_sync_sgd"]
