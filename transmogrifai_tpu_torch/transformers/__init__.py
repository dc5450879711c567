"""Feature-engineering transformers (counterpart of transformers/): the
math ops, the numeric and vector misc stages, and the text analyzer."""
from . import math, misc, text  # noqa: F401 — registered stage modules

__all__ = ["math", "misc", "text"]
