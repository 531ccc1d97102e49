"""Probe tools of the port: python -m cudasp_tpu_torch.tools.<name>, for
alu_probe, microbench and stage_profile."""
