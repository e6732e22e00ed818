"""switch_s: the seconds of every model switch that ended inside the
window, over their count; a switch runs from the outgoing instance's
``sleep()`` to the incoming instance's ``wake()`` returning with its
weights usable."""
WRAPS = []


def read(run):
    done = [s.end - s.start for s in run.switches if run.in_window(s.end)]
    return sum(done) / len(done) if done else None
