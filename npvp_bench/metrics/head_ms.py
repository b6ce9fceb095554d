"""Device ms a request inside the port's ``npvp.ae.head`` spans (the AE
decoder's tail: the last upsampling's BatchNorm and ReLU, the reflect pad,
the 7x7 head and its activation), over the requests
(``npvp.serve.request`` spans) of the traced stretch with the port's spans
on. A program without the span reads nothing."""


def read(rec):
    found = rec.get("spans") or {}
    calls, requests = found.get("npvp.ae.head"), found.get(
        "npvp.serve.request")
    return 1e3 * sum(calls) / len(requests) if calls and requests else None
