"""Training runtime: the paper's explicit data-parallel step and the loop,
straggler mitigation and elastic resharding."""
from repro_torch.runtime.elastic import make_mesh_for, reshard, shrink_batch
from repro_torch.runtime.straggler import (StragglerSim, compare_policies,
                                           run_policy)

__all__ = ["StragglerSim", "run_policy", "compare_policies",
           "make_mesh_for", "reshard", "shrink_batch"]
