# Content-addressed process caching (AiiDA 1.0 §caching; paper §II).
#
# A process's inputs are hashed into a canonical fingerprint at node
# creation; before executing, the engine may look up an earlier
# finished-ok node with the same fingerprint and reuse its outputs
# instead of recomputing — provenance stays honest because the outputs
# are cloned as new nodes linked to the new process node, which records
# `cached_from` in its metadata.

from repro_torch.caching.backfill import (  # noqa: F401
    BackfillStats, backfill_hashes,
)
from repro_torch.caching.config import (  # noqa: F401
    CachingPolicy, disable_caching, enable_caching, get_policy,
    is_caching_enabled_for, reset_policy,
)
from repro_torch.caching.hashing import (  # noqa: F401
    compute_input_hash, hash_data_value,
)
from repro_torch.caching.registry import CacheHit, CacheRegistry  # noqa: F401
