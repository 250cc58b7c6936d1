"""Tenant workloads: the trainer (one device, or dp x tp over ranks), ring
attention and its Hopper kernel, the pipeline, the MoE layer, and the rank
processes that run the distributed ones."""
