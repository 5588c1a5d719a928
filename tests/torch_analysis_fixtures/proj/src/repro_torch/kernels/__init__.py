"""Fake kernel package root: ``load_kernel`` stands for the port's build
helper (the launch detector keys on a call of an attribute of its
result)."""


def load_kernel(name):
    raise RuntimeError(f"fixture: no library for {name}")
