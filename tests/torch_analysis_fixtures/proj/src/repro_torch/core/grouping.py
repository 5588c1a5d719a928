"""cache-key fixtures for the grouping-cache shape: memoizing a geometric
grouping while keying only on the member signature.  The positive is the
bug class the pinned-gamma work guards against — ``gamma`` rescales change
the bucket boundaries, so a cache keyed on the jobs alone serves groups
computed under a stale gamma."""
from .memo import _LRU

groups_cache = _LRU()


def cached_groups(sig, gamma):
    # cache-key POSITIVE: `gamma` shapes the bucket boundaries (the value)
    # but the key carries only the member signature
    key = ("groups", sig)
    found, val = groups_cache.lookup(key)
    if found:
        return val
    val = [k // gamma for k in range(sig)]
    groups_cache.store(key, val)
    return val


def cached_groups_sound(sig, gamma):
    # cache-key NEGATIVE: gamma is folded into the key alongside the
    # membership signature, so rescales miss instead of serving stale groups
    key = ("groups", sig, gamma)
    found, val = groups_cache.lookup(key)
    if found:
        return val
    val = [k // gamma for k in range(sig)]
    groups_cache.store(key, val)
    return val
