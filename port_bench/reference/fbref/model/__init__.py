from .error_model import (
    ErrorModel,
    ModelStats,
    alignment_error_log10,
    collect_stats,
    compute_gap_prob_cutoff,
    finalize_model,
)

__all__ = [
    "ModelStats",
    "ErrorModel",
    "collect_stats",
    "finalize_model",
    "alignment_error_log10",
    "compute_gap_prob_cutoff",
]
