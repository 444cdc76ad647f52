"""Mean host time of one ``StreamingEngine.finalize_batch`` call in the
window (the harness's span, wrapped around the engine from outside): the
final chunk step and the drain of the finishing streams' last blocks, which
moves ``final_p95_ms``."""


def read(rec):
    v = rec["spans"].get("engine.finalize_batch")
    return v if v == v else None
