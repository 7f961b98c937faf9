"""Training runtime: the paper's explicit data-parallel step and the loop."""
