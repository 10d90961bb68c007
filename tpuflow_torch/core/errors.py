"""Structured error reporting (port of :mod:`tpuflow.core.errors`).

The reference carries an ``ERROR`` object that remembers function, value
and file names and prints ``*** <fn> error - ...`` diagnostics before
unwinding (lib/Class.h:13-57, main.cpp:466-476). Here errors are
exceptions with the same message shape: a :class:`TpuflowError` hierarchy
that reports an ``error`` event through
:mod:`tpuflow_torch.utils.telemetry` when raised.
"""

from __future__ import annotations

from tpuflow_torch.utils.telemetry import get_telemetry


class TpuflowError(RuntimeError):
    """Base error carrying the reference ERROR fields."""

    kind = "error"

    def __init__(self, function: str, value: str = "", file: str = "",
                 detail: str = ""):
        self.function = function
        self.value = value
        self.file = file
        msg = f"*** {function} error"
        if value:
            msg += f" - value ({value})"
        if file:
            msg += f" - file '{file}'"
        if detail:
            msg += f" : {detail}"
        get_telemetry().event("error", kind=self.kind, function=function,
                              value=value, file=file, detail=detail)
        super().__init__(msg)


class FunctionFailError(TpuflowError):
    kind = "function_fail"          # ERROR::FunctionFail


class ValueIncorrectError(TpuflowError):
    kind = "value_incorrect"        # ERROR::ValueIncorrect


class PointerNullError(TpuflowError):
    kind = "pointer_null"           # ERROR::PointerNull (None where required)


class FileReadError(TpuflowError):
    kind = "file_read"              # ERROR::FileRead


class FileWriteError(TpuflowError):
    kind = "file_write"             # ERROR::FileWrite
