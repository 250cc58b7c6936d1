"""The tenant's runtime client: its limits and its interposer."""
