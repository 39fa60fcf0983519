from .assign import GapBundle, Triage

__all__ = ["Triage", "GapBundle"]
