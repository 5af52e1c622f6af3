"""Profiling entry points of the port (`python -m
rcmvsnet_tpu_torch.tools.<name>`): `profile_breakdown` (the eval cascade
by component), `profile_conv3d` (K9 at the CostRegNet's layer shapes)
and `profile_train` (the train step by pass, and a traced step split by
kernel)."""
