"""sims_per_s: members of all forward calls completed in the window, over
the time from the window's start to the end of the last call (host clock)."""


def read(run):
    if run.entry != "forward" or not run.calls:
        return None
    return run.members * len(run.calls) / (run.calls[-1][1] - run.window_start)
