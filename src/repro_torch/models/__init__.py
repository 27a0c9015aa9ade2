"""The LM seed stack of the port: configs resolve to model functions
through ``build_model``; ``lm_engine`` serves them."""
from repro_torch.models.registry import build_model  # noqa: F401
