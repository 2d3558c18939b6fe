"""Wire protocol types and constants (own copy of ``grapevine_tpu/wire``'s
pure-Python modules; the port imports nothing of the JAX package)."""

from .constants import *  # noqa: F401,F403
from .records import QueryRequest, QueryResponse, Record, RequestRecord  # noqa: F401
