"""The fleet tier of the compile cache (the port of the JAX package's
clustercache/): a node advertises its warm entries (`advertise`), and a
cold node's miss fetches one from a warm peer's exporter before it
compiles (`fetch`), behind the ClusterCompileCache gate. The scheduler's
warm-preference term is not carried."""

from vtpu_manager_torch.clustercache.advertise import (  # noqa: F401
    CacheAdvertiser, NodeWarmKeys, parse_warm_keys)
from vtpu_manager_torch.clustercache.fetch import (  # noqa: F401
    ClusterCompileCache, FetchError, read_entry_for_serving)
