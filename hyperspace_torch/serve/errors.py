"""The serve error taxonomy (counterpart of ``hyperspace_tpu/serve/errors.py``).

Every failed request answers with a machine-readable ``error.kind``:

==================  ====================================================
kind                meaning
==================  ====================================================
``parse``           the input line is not valid JSON
``validation``      valid JSON, invalid request (bad op, bad ids/k,
                    wrong types — the reject-don't-coerce failures)
``deadline_exceeded``  the request's ``deadline_ms`` expired before an
                    honest answer existed (never dispatched late)
``overloaded``      admission control shed the request (bounded queue
                    full), the server is draining, or the degradation
                    ladder answers cache-only and the request missed
``unknown_tenant``  the named tenant / fingerprint is not served here
``internal``        anything else — a server-side bug
==================  ====================================================

The HTTP front door maps the kinds onto status codes: ``parse`` and
``validation`` 400, ``overloaded`` 429, ``deadline_exceeded`` 504,
``unknown_tenant`` 404 (the multi-tenant registry, or a fingerprint a
single-tenant door does not serve), ``internal`` 500.
"""

from __future__ import annotations


ERROR_KINDS = ("parse", "validation", "deadline_exceeded", "overloaded",
               "unknown_tenant", "internal")


class ServeError(Exception):
    """Base of the typed serve failures; ``kind`` is the wire value."""

    kind = "internal"

    def payload(self) -> dict:
        """The response-line body: ``{"kind": ..., "message": ...}``."""
        return {"kind": self.kind, "message": str(self)}


class OverloadedError(ServeError):
    """Admission queue full (shed), draining, or a cache-only miss."""

    kind = "overloaded"


class DeadlineExceededError(ServeError):
    """The request's deadline expired before an honest answer existed."""

    kind = "deadline_exceeded"


class UnknownTenantError(ServeError):
    """The named tenant or fingerprint is not served here: 404, not a
    400 — a client must tell a typo'd payload from a tenant that was
    never registered (or already retired)."""

    kind = "unknown_tenant"

    def __init__(self, tenant):
        super().__init__(f"unknown tenant or fingerprint: {tenant!r}")
        self.tenant = tenant


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
