"""Host ms from the call of ``Engine.frame`` to its return, the mean over
the window's (unprofiled) frames."""


def read(rec):
    d = rec.get("dispatch_s")
    return sum(d) / len(d) * 1e3 if d else None
