"""Data-parallel scanning over several devices (counterpart of
cudasp_tpu/parallel): a one-axis device mesh whose entries each run the
scan kernel over their own contiguous lane shard (mesh), the row exchange
that evens out live rows across the shards (exchange), the hash partition
of a table across processes (partition) and the cross-process match merge
on torch.distributed (distributed)."""
