"""The node's compile cache, shared by the tenants of a node (the port of
the JAX package's compilecache/): `keys` for what makes two compiles the
same, `cache` for the store. The scheduler's anti-storm term
(`antistorm.py`) belongs to the scheduler, which the port does not
carry."""

from vtpu_manager_torch.compilecache.cache import (CacheStats,  # noqa: F401
                                                   CompileCache)
from vtpu_manager_torch.compilecache.keys import entry_key  # noqa: F401
