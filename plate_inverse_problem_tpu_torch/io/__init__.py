"""Run artifacts of the inverse problem: FRF compression, the report and
the history log, and optimizer checkpoints."""
from .compress import Compressor
from .report import default_uid, write_log, write_report
from .checkpoint import save_checkpoint, load_checkpoint, checkpointed_optimize

__all__ = ["Compressor", "default_uid", "write_log", "write_report",
           "save_checkpoint", "load_checkpoint", "checkpointed_optimize"]
