"""replay_gap_us (us): the device's idle time between one replay's last
device event and the next replay's first, averaged over the replays of
the traced window. Replays are told apart by the harness's read-out of
each replay's probes (the only device-to-host copy of a stream cell),
which lies between them and counts as busy."""


def read(view):
    if view.kind != "stream":
        return None
    reps = view.replays()
    if len(reps) < 2:
        return None
    idle = []
    for a, b in zip(reps, reps[1:]):
        lo, hi = a[-1][2], b[0][1]
        idle.append(max(0.0, (hi - lo) - view.busy_us(lo, hi)))
    return sum(idle) / len(idle)
