"""Rule modules — importing this package registers every rule (the same
import-time registration the scheduler and scenario registries use).
Syntactic (file/project scope) rules first, then the program-scope
dataflow rules built on :mod:`repro_torch.analysis.flow`."""
from . import dispatch     # noqa: F401  backend-dispatch
from . import frozen       # noqa: F401  frozen-core-types
from . import overflow     # noqa: F401  overflow-guard
from . import pragma_rule  # noqa: F401  pragma-discipline
from . import purity       # noqa: F401  jit-purity
from . import registry_check  # noqa: F401  registry-consistency
from . import rng          # noqa: F401  rng-discipline

from . import cache_key      # noqa: F401  cache-key (dataflow)
from . import overflow_range  # noqa: F401  overflow-range (dataflow)
from . import tracer_taint   # noqa: F401  tracer-taint (dataflow)
