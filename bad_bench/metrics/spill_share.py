"""``spill_share``: sIDs that missed a tick's notify buffer and waited in
the retry ring or the spill queue, over the sIDs produced, in the window's
ticks (``DeliveryStats``), in %."""


def read(run):
    spilled = produced = 0
    for t in run.window:
        for _, _, _, st in t.reports.values():
            ds, ss, xs = st[3], st[4], st[5]
            spilled += ss
            produced += ds + ss + xs
    if not produced:
        return None
    return 100.0 * spilled / produced
