from .trace import StageTimer, trace_context
from .checkpoint import save_model, load_model, latest_iteration

__all__ = ["StageTimer", "trace_context", "save_model", "load_model",
           "latest_iteration"]
