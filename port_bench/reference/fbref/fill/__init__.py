from .driver import FillResult, fill_gaps, plan_gaps
from .em import FillConfig, fill_batch, finalize_batch

__all__ = [
    "fill_gaps",
    "plan_gaps",
    "FillResult",
    "FillConfig",
    "fill_batch",
    "finalize_batch",
]
