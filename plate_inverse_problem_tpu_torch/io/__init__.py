"""Run artifacts of the inverse problem: the report and the history log."""
from .report import default_uid, write_log, write_report

__all__ = ["default_uid", "write_log", "write_report"]
