"""Profiling entry points of the port (`python -m
rcmvsnet_tpu_torch.tools.<name>`): `profile_breakdown` (the eval cascade
by component) and `profile_conv3d` (K9 at the CostRegNet's layer
shapes)."""
