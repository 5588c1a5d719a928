"""rng-discipline: randomness must flow through a seeded generator
parameter — a ``np.random.default_rng(seed)`` Generator (the named-stream
convention of ``core/traces.py`` / ``core/stream.py``: seed, seed+1,
seed+2) or a seeded ``torch.Generator`` passed as ``generator=`` (the
models' weights, ``models/layers.py``).  Global seeding and draws from a
global stream make results depend on call order, which breaks the
bit-identity contracts the equivalence tests pin.

Flagged outside tests: ``np.random.seed`` and module-level
``np.random.*`` draws, an unseeded ``default_rng()``, stdlib ``random.*``;
torch's global generator: ``torch.manual_seed``, ``torch.seed``,
``torch.cuda.manual_seed*``, ``torch.rand*`` / ``randn*`` / ``randint*`` /
``randperm`` / ``bernoulli`` / ``multinomial`` / ``normal`` without
``generator=``, and the in-place ``.uniform_`` / ``.normal_`` /
``.bernoulli_`` / ``.random_`` without ``generator=``."""
from __future__ import annotations

import ast

from .. import FileContext, register_rule
from ._util import dotted, import_aliases, resolve

# numpy.random attributes that are seeded-construction, not draws
_CONSTRUCTORS = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "MT19937", "SFC64", "BitGenerator", "RandomState"}

# torch draws that take the global generator unless given generator=
_TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint",
                "randint_like", "randperm", "bernoulli", "multinomial",
                "normal", "poisson"}
_TORCH_SEEDS = {"torch.manual_seed", "torch.seed", "torch.initial_seed",
                "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                "torch.cuda.seed", "torch.cuda.seed_all",
                "torch.random.manual_seed", "torch.random.seed"}
_INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "random_",
                  "exponential_", "geometric_", "cauchy_", "log_normal_"}

_HINT = ("thread a seeded generator through a parameter: "
         "np.random.default_rng(seed) (named streams: seed, seed+1, ... as "
         "in core/traces.py) or torch.Generator(device).manual_seed(seed) "
         "passed as generator=")


def _has_generator(node: ast.Call) -> bool:
    return any(k.arg == "generator" for k in node.keywords)


@register_rule("rng-discipline",
               "no np.random.seed / module-level np.random.* / stdlib "
               "random.* / torch's global generator (manual_seed, draws "
               "without generator=) outside testing; randomness flows "
               "through a seeded generator parameter")
def _rng_discipline(ctx: FileContext):
    if ctx.in_testing():
        return
    aliases = import_aliases(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _INPLACE_DRAWS and \
                not _has_generator(node):
            yield ctx.finding(
                "rng-discipline", node,
                f".{node.func.attr}() without generator= draws from "
                "torch's global generator", _HINT)
            continue
        full = resolve(node.func, aliases)
        if full is None:
            continue
        if full == "numpy.random.seed":
            yield ctx.finding(
                "rng-discipline", node,
                "np.random.seed() sets hidden global state", _HINT)
        elif full.startswith("numpy.random."):
            attr = full.rsplit(".", 1)[-1]
            if attr not in _CONSTRUCTORS:
                yield ctx.finding(
                    "rng-discipline", node,
                    f"module-level draw np.random.{attr}() uses the "
                    "unseeded global stream", _HINT)
            elif attr == "default_rng" and not node.args and not node.keywords:
                yield ctx.finding(
                    "rng-discipline", node,
                    "default_rng() without a seed is entropy-seeded and "
                    "irreproducible", _HINT)
        elif full in _TORCH_SEEDS:
            yield ctx.finding(
                "rng-discipline", node,
                f"{full}() sets torch's hidden global generator", _HINT)
        elif full.startswith("torch.") and \
                full.rsplit(".", 1)[-1] in _TORCH_DRAWS and \
                full.count(".") == 1 and not _has_generator(node):
            yield ctx.finding(
                "rng-discipline", node,
                f"{full}() without generator= draws from torch's global "
                "generator", _HINT)
        elif full == "random" or full.startswith("random."):
            # only flag names actually bound by an import of the stdlib
            # module — never a local variable that happens to be `random`
            parts = dotted(node.func)
            bound = aliases.get(parts[0]) if parts else None
            if bound is not None and (bound == "random"
                                      or bound.startswith("random.")):
                yield ctx.finding(
                    "rng-discipline", node,
                    f"stdlib {full}() draws from unseeded global state",
                    _HINT)
