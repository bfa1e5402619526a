"""accel_build_s: host clock around the scene's and its tables' build in
set-up (s)."""


def read(run):
    return run.build["accel_build"][0]
