"""The paper's data-parallel gradient sync over ``torch.distributed``:
flat and hierarchical all-reduce (C5) and compressed all-gather with error
feedback (C6, Eq. 10-11)."""
