"""Mean host time of one ``SessionManager.tick`` call in the window (the
harness's span around it): a chunk waits for the tick in flight and then
its own, so this moves ``partial_p95_ms``."""


def read(rec):
    v = rec["spans"].get("serve.tick")
    return v if v == v else None
