"""Tools of the port: python -m cudasp_tpu_torch.tools.<name>. The probes
alu_probe, microbench and stage_profile; autotune; kernel_probe,
h2d_probe, concurrency_probe, ablate_probe, scaling_probe,
multihost_bench, seed_cache and first_contact, on tables from dataset."""
