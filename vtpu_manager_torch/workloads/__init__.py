"""Tenant workloads: the trainer, attention and its Hopper kernel."""
