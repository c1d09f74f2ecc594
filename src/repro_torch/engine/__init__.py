"""Serving runtime of the port: the continuous-batching generation engine
and the backend that serves an analytics tier from it."""
from repro_torch.engine.engine import (ContinuousBatcher,  # noqa: F401
                                       GenerationEngine, Request)
from repro_torch.engine.torch_backend import (TorchBackend,  # noqa: F401
                                              render_prompt)
