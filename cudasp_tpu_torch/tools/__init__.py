"""Tools of the port: python -m cudasp_tpu_torch.tools.<name>, for the
probes alu_probe, microbench and stage_profile, and autotune."""
