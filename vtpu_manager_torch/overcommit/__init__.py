"""HBMOvercommit's node half: the ratio annotation (`ratio`), the policy
that computes it from the rings and its publisher (`policy`, over
`ledger`), and the host pool with its budget and reaper (`spill`)."""
