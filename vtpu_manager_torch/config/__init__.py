"""The node's shared files: config, memory ledger, utilization feed."""
