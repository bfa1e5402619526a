"""One reader a metric: ``<name>.py`` defines ``read(run)``, which takes
the run's record (quakebench/run.py ``Run``) and returns the metric's
value, or None where the run has nothing to read for it (the harness
then leaves the metric out of the line)."""
