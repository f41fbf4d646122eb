"""Cross-cutting utilities: persistence (checkpoint/resume, exports) and
observability (structured logs, phase timing, device profiling)."""
# straight from the observe package — importing the deprecated
# ``utils.observe`` shim here would warn on every ``utils`` import
from ..observe import Phases, configure_logging, log_event, profile_to
from .persist import (
    export_encoding,
    load_incremental,
    load_packed,
    load_result,
    save_incremental,
    save_packed,
    save_result,
)

__all__ = [
    "Phases",
    "configure_logging",
    "log_event",
    "profile_to",
    "export_encoding",
    "load_incremental",
    "load_packed",
    "load_result",
    "save_incremental",
    "save_packed",
    "save_result",
]
