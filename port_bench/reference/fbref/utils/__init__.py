from .trace import StageTimer, trace_context

__all__ = ["StageTimer", "trace_context"]
