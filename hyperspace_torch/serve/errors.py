"""The serve error taxonomy (counterpart of ``hyperspace_tpu/serve/errors.py``).

Every failed request answers with a machine-readable ``error.kind``:

==================  ====================================================
kind                meaning
==================  ====================================================
``parse``           the input line is not valid JSON
``validation``      valid JSON, invalid request (bad op, bad ids/k,
                    wrong types — the reject-don't-coerce failures)
``deadline_exceeded``  the request's deadline expired first
``overloaded``      admission control shed the request
``unknown_tenant``  the named tenant / fingerprint is not served here
``internal``        anything else — a server-side bug
==================  ====================================================

The port has no deadlines, admission control or tenants yet, so only
``parse``, ``validation`` and ``internal`` occur; the kinds keep their
wire values so a client branches the same way on either package.
"""

from __future__ import annotations


class ServeError(Exception):
    """Base of the typed serve failures; ``kind`` is the wire value."""

    kind = "internal"

    def payload(self) -> dict:
        """The response-line body: ``{"kind": ..., "message": ...}``."""
        return {"kind": self.kind, "message": str(self)}


def kind_of(exc: BaseException) -> str:
    """The taxonomy kind an exception answers with."""
    if isinstance(exc, ServeError):
        return exc.kind
    if isinstance(exc, (ValueError, KeyError, TypeError, OverflowError)):
        return "validation"
    return "internal"


def error_response(exc: BaseException) -> dict:
    """``{"error": {"kind": ..., "message": ...}}`` for a failed request."""
    if isinstance(exc, ServeError):
        return {"error": exc.payload()}
    return {"error": {"kind": kind_of(exc),
                      "message": f"{type(exc).__name__}: {exc}"}}
