"""draw_ms.train (ms, program span): mean host time of the window's calls
to engine/draws.Draws.next_chunk."""


def read(rec):
    t = rec["spans"].get("draw")
    if rec.get("unit") != "step" or not t:
        return None
    return 1e3 * sum(t) / len(t)
