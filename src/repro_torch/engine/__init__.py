"""Serving runtime of the port: the continuous-batching generation engine."""
from repro_torch.engine.engine import (ContinuousBatcher,  # noqa: F401
                                       GenerationEngine, Request)
