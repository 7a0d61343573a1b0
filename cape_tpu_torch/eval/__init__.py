"""Evaluation of the port (copies of `cape_tpu.eval`): the decode wrapper,
PCK@bbox, the autoregressive eval loop and the leak audit."""

from .audit import audit_episodes, format_audit_report
from .evaluate import evaluate_cape
from .pck import PCKEvaluator, compute_pck_bbox

__all__ = ["PCKEvaluator", "compute_pck_bbox", "evaluate_cape",
           "audit_episodes", "format_audit_report"]
