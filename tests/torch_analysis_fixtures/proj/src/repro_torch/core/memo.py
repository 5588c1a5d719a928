"""cache-key fixtures: one caching function leaks a parameter into the
value only, one reads an environment variable the key omits, one is sound,
and one takes the dispatch selectors (device, plan_backend) the port's
tests hold neutral.  There is no syntactic rule for cache keys at all, so
the positives are invisible to the file-scope layer by construction."""
import os


class _LRU:
    def __init__(self):
        self._d = {}

    def lookup(self, k):
        return (k in self._d, self._d.get(k))

    def store(self, k, v):
        self._d[k] = v


plan_cache = _LRU()


def cached_plan(n, scale):
    # cache-key POSITIVE: `scale` shapes the value but not the key
    key = ("plan", n)
    found, val = plan_cache.lookup(key)
    if found:
        return val
    val = [i * scale for i in range(n)]
    plan_cache.store(key, val)
    return val


def cached_env(n):
    # cache-key POSITIVE: FAKE_MODE changes the value, the key omits it
    key = ("env", n)
    found, val = plan_cache.lookup(key)
    if found:
        return val
    val = n * (2 if os.getenv("FAKE_MODE") == "x" else 1)
    plan_cache.store(key, val)
    return val


def cached_sound(n, scale):
    # cache-key NEGATIVE: every value input reaches the key
    key = ("sound", n, scale)
    found, val = plan_cache.lookup(key)
    if found:
        return val
    val = [i * scale for i in range(n)]
    plan_cache.store(key, val)
    return val


def cached_on_device(n, device, plan_backend):
    # cache-key NEGATIVE: device and plan_backend select where and how the
    # value is computed, never what it is (card = CPU, held by tests)
    key = ("dev", n)
    found, val = plan_cache.lookup(key)
    if found:
        return val
    val = [(i, device, plan_backend)[0] for i in range(n)]
    plan_cache.store(key, val)
    return val
