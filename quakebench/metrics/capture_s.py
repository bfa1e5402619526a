"""capture_s: host clock around the compiled frame's first call (its
warm-up frames, the capture and the first replay) in set-up (s)."""


def read(run):
    return run.build["capture"][0]
