"""replay_share.train (%, program counter): share of the window's steps
that engine/graphs.StepGraphs ran as a replay of a captured graph."""


def read(rec):
    if rec.get("unit") != "step" or not rec.get("units"):
        return None
    return 100.0 * rec["stats"].get("replay", 0) / rec["units"]
