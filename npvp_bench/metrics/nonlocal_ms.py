"""Device ms a request inside the port's ``npvp.ae.nonlocal`` spans (the
AE encoder's non-local attentions), over the requests
(``npvp.serve.request`` spans) of the traced stretch with the port's
spans on."""


def read(rec):
    found = rec.get("spans") or {}
    calls, requests = found.get("npvp.ae.nonlocal"), found.get(
        "npvp.serve.request")
    return 1e3 * sum(calls) / len(requests) if calls and requests else None
