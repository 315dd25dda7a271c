"""Process groups and the data-parallel collectives
(:mod:`ddp_tpu_torch.parallel.dist`)."""
