"""Run artifacts of the inverse problem: FRF compression, the report and
the history log."""
from .compress import Compressor
from .report import default_uid, write_log, write_report

__all__ = ["Compressor", "default_uid", "write_log", "write_report"]
