"""Mean host time of one ``StreamingEngine.tick`` call in the window (the
harness's span): at a full pool the tick is what ``audio_rate`` divides."""


def read(rec):
    v = rec["spans"].get("engine.tick")
    return v if v == v else None
