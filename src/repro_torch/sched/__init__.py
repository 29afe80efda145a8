"""repro_torch.sched — the scheduling-policy protocol, the serving admission
registry and the CUDA backend of the credit tick (see each submodule)."""
