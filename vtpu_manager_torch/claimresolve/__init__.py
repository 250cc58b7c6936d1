"""Which devices a pod holds through DRA claims (see resolve.py)."""
